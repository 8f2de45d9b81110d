"""windflow_tpu_torch — the PyTorch/CUDA port of windflow_tpu.

The same dataflow API (PipeGraph, MultiPipe, fluent builders, watermarks,
execution modes) on one NVIDIA GPU.  Device operators take the reference's
GPU names (``MapGPU_Builder``, ``FilterGPU_Builder``,
``ReduceGPU_Builder``, ``Ffat_WindowsGPU_Builder``) beside the host ones
(``Map_Builder``, ``Filter_Builder``, ``FlatMap_Builder``,
``Reduce_Builder``, the host window builders ``Keyed_Windows_Builder``,
``Parallel_Windows_Builder``, ``Paned_Windows_Builder``,
``MapReduce_Windows_Builder`` and ``Ffat_Windows_Builder`` over the
window engine of ``windflow_tpu_torch/windows``, and the persistent
``P_*_Builder``s of ``windflow_tpu_torch/persistent``, whose keyed state
lives in an embedded KV store); ``MapGPU_Builder`` / ``FilterGPU_Builder`` with
``withInitialState`` build the keyed stateful operators
(``StatefulMapGPU``, ``StatefulFilterGPU``).  MultiPipes split, select
and merge, keyed edges route to several replicas, whole-chain fusion
runs each operator chain as one hop (``windflow_tpu_torch/fusion``),
and key compaction maps arbitrary int32 keys onto dense slots
(``windflow_tpu_torch/parallel/compaction.py``).  The FFAT hot loop and
the reduce's dense tables run hand-written CUDA kernels
(``windflow_tpu_torch/kernels``).  The bulk sources ``FrameSource``
and ``DeviceSource`` (``windflow_tpu_torch/io``) feed the card
columnar.  On the card a staged edge ships wire-compressed batches
(``windflow_tpu_torch/wire.py``) and runs K of them as one captured
CUDA graph (``windflow_tpu_torch/megastep.py``).  ``Config.durability``
checkpoints a graph's state at watermark-aligned epochs and
``PipeGraph.restore`` resumes it, its Kafka and file sinks exactly once
(``windflow_tpu_torch/durability``).  The observability planes
(``windflow_tpu_torch/monitoring``) trace sampled batches from staging to
the sink, judge each operator's health, name a stall's root cause and
write a postmortem bundle, and attribute dispatches, bytes and key skew
per hop and shard (``PipeGraph.stats()``).  ``PipeGraph.start()``
runs the preflight checker first (``windflow_tpu_torch/analysis``):
the whole graph evaluated on fake tensors, every finding at once, under
``Config.preflight``.  ``Config.reshard_executor`` turns on the
serving plane (``windflow_tpu_torch/serving``): the reshard executor
moves keys (and their state) between replicas of a live graph,
pre-aggregates hot keys and throttles the sources when no plan helps.
Bulk parsing, keyed partitioning, the wide watermark fold and the KV
store run in the native host library (``windflow_tpu_torch/native``,
built with g++ at first use).  The card is the default
device: ``Config(device="cpu")`` runs on the CPU, where each kernel
wrapper takes its plain torch version.  The package imports
torch and numpy, never jax.
"""

from windflow_tpu_torch import staging
from windflow_tpu_torch.analysis.debug_concurrency import \
    ConcurrencyViolation
from windflow_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                     PreflightError,
                                                     PreflightWarning)
from windflow_tpu_torch.analysis.hotpath import hot_path
from windflow_tpu_torch.basic import (EMPTY_KEY, Config, ExecutionMode,
                                      RoutingMode, TimePolicy, WindFlowError,
                                      WinType, current_time_usecs,
                                      default_config, stable_hash)
from windflow_tpu_torch.batch import (DeviceBatch, HostBatch, Punctuation,
                                      device_to_host, host_to_device)
from windflow_tpu_torch.context import LocalStorage, RuntimeContext
from windflow_tpu_torch.durability.sinks import EpochFileSink
from windflow_tpu_torch.graph.builders import (DeviceSource_Builder,
                                               Ffat_Windows_Builder,
                                               Ffat_WindowsGPU_Builder,
                                               Filter_Builder,
                                               FilterGPU_Builder,
                                               FlatMap_Builder,
                                               Keyed_Windows_Builder,
                                               Map_Builder, MapGPU_Builder,
                                               MapReduce_Windows_Builder,
                                               Paned_Windows_Builder,
                                               Parallel_Windows_Builder,
                                               Reduce_Builder,
                                               ReduceGPU_Builder, Sink_Builder,
                                               Source_Builder)
from windflow_tpu_torch.graph.multipipe import MultiPipe
from windflow_tpu_torch.graph.pipegraph import PipeGraph
from windflow_tpu_torch.io import DeviceSource, FrameSource
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.ops.filter_op import Filter
from windflow_tpu_torch.ops.flatmap_op import FlatMap, Shipper
from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU
from windflow_tpu_torch.ops.gpu_stateful import (StatefulFilterGPU,
                                                 StatefulMapGPU)
from windflow_tpu_torch.ops.map_op import Map
from windflow_tpu_torch.ops.reduce import ReduceGPU
from windflow_tpu_torch.ops.reduce_op import Reduce
from windflow_tpu_torch.ops.sink import Sink, SinkColumns
from windflow_tpu_torch.ops.source import Source
from windflow_tpu_torch.persistent import (DBHandle, LogKV, PFilter,
                                           PFlatMap, PKeyedWindows, PMap,
                                           PReduce, PSink, P_Filter_Builder,
                                           P_FlatMap_Builder,
                                           P_Keyed_Windows_Builder,
                                           P_Map_Builder, P_Reduce_Builder,
                                           P_Sink_Builder)
from windflow_tpu_torch.staging import StagingPool
from windflow_tpu_torch.windows.engine import WindowSpec
from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
from windflow_tpu_torch.windows.ffat_op import FfatWindows
from windflow_tpu_torch.windows.flatfat import FlatFAT
from windflow_tpu_torch.windows.ops import (KeyedWindows, MapReduceWindows,
                                            PanedWindows, ParallelWindows,
                                            WindowResult)

__all__ = [
    "Config", "EMPTY_KEY", "ExecutionMode", "RoutingMode", "TimePolicy",
    "WindFlowError", "WinType", "current_time_usecs", "default_config",
    "stable_hash", "DeviceBatch", "HostBatch", "Punctuation",
    "device_to_host", "host_to_device", "LocalStorage", "RuntimeContext",
    "MultiPipe", "PipeGraph", "Operator", "Replica", "Source", "Map",
    "Filter", "FlatMap", "Shipper", "Reduce", "Sink", "SinkColumns",
    "MapGPU", "FilterGPU", "ReduceGPU", "StatefulMapGPU",
    "StatefulFilterGPU", "DeviceSource", "FrameSource", "Source_Builder",
    "DeviceSource_Builder", "Map_Builder", "Filter_Builder",
    "FlatMap_Builder", "Reduce_Builder", "Sink_Builder", "MapGPU_Builder",
    "FilterGPU_Builder", "ReduceGPU_Builder", "WindowSpec",
    "FfatWindowsGPU", "Ffat_WindowsGPU_Builder", "LogKV", "staging",
    "StagingPool", "Diagnostic", "EpochFileSink", "PreflightError",
    "PreflightWarning", "ConcurrencyViolation", "hot_path",
    "WindowResult", "KeyedWindows", "ParallelWindows", "PanedWindows",
    "MapReduceWindows", "FfatWindows", "FlatFAT", "Keyed_Windows_Builder",
    "Parallel_Windows_Builder", "Paned_Windows_Builder",
    "MapReduce_Windows_Builder", "Ffat_Windows_Builder", "DBHandle",
    "PMap", "PFilter", "PFlatMap", "PReduce", "PSink", "PKeyedWindows",
    "P_Map_Builder", "P_Filter_Builder", "P_FlatMap_Builder",
    "P_Reduce_Builder", "P_Sink_Builder", "P_Keyed_Windows_Builder",
]
