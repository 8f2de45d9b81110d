"""windflow_tpu_torch — the PyTorch/CUDA port of windflow_tpu.

The same dataflow API (PipeGraph, MultiPipe, fluent builders, watermarks,
execution modes) on one NVIDIA GPU.  Device operators take the reference's
GPU names (``MapGPU_Builder``, ``FilterGPU_Builder``,
``ReduceGPU_Builder``, ``Ffat_WindowsGPU_Builder``); the FFAT hot loop and
the reduce's dense tables run hand-written CUDA kernels
(``windflow_tpu_torch/kernels``).  The bulk sources ``FrameSource``
and ``DeviceSource`` (``windflow_tpu_torch/io``) feed the card
columnar.  The card is the default device: ``Config(device="cpu")``
runs on the CPU, where each kernel wrapper takes its plain torch
version.  The package imports torch and numpy, never jax.
"""

from windflow_tpu_torch.basic import (Config, ExecutionMode, RoutingMode,
                                      TimePolicy, WindFlowError, WinType,
                                      current_time_usecs, default_config)
from windflow_tpu_torch.context import LocalStorage, RuntimeContext
from windflow_tpu_torch.graph.builders import (DeviceSource_Builder,
                                               Ffat_WindowsGPU_Builder,
                                               FilterGPU_Builder,
                                               MapGPU_Builder,
                                               ReduceGPU_Builder, Sink_Builder,
                                               Source_Builder)
from windflow_tpu_torch.graph.multipipe import MultiPipe
from windflow_tpu_torch.graph.pipegraph import PipeGraph
from windflow_tpu_torch.io import DeviceSource, FrameSource
from windflow_tpu_torch.ops.sink import SinkColumns

__all__ = [
    "Config", "ExecutionMode", "RoutingMode", "TimePolicy", "WindFlowError",
    "WinType", "current_time_usecs", "default_config", "LocalStorage",
    "RuntimeContext", "DeviceSource", "DeviceSource_Builder", "FrameSource",
    "Ffat_WindowsGPU_Builder", "FilterGPU_Builder", "MapGPU_Builder",
    "ReduceGPU_Builder", "Sink_Builder", "Source_Builder", "MultiPipe",
    "PipeGraph", "SinkColumns",
]
