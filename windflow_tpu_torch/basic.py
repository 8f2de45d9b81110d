"""Basic definitions: enums, the runtime :class:`Config`, small helpers.

The port's copy of ``windflow_tpu/basic.py`` (which imports no JAX but is
not imported across: the port stands alone).  ``Config`` has every
field of the JAX package's, with the JAX package's defaults
(``wire_compression`` and ``megastep_sweeps`` resolve "auto" from
``device``; ``mesh`` is a ``parallel.mesh.Mesh`` of torch devices),
plus the two the port adds: ``device`` (the card unless the caller asks
for the CPU) and ``cuda_kernels`` (the kernel switch, counterpart of
``Config.pallas_kernels``).  The observability fields
keep the JAX package's names and defaults, ``profiler_dir`` pointing at
a ``torch.profiler`` capture; only those of the monitoring thread, of
the latency, tenant, calibration and roofline planes and of the reshard
executor read the JAX package's ``WF_TPU_*`` environment knobs.
``stable_hash`` and ``int32_key`` are the port's own copies of the JAX
package's key rules.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
import zlib


class ExecutionMode(enum.Enum):
    """How replicas treat out-of-order inputs (reference ``basic.hpp:78``).

    * DEFAULT        – out-of-order processing gated by watermarks.
    * DETERMINISTIC  – inputs re-ordered by id/timestamp before processing.
    * PROBABILISTIC  – approximate ordering with an adaptive K-slack buffer.
    """

    DEFAULT = "default"
    DETERMINISTIC = "deterministic"
    PROBABILISTIC = "probabilistic"


class TimePolicy(enum.Enum):
    """Timestamping policy (reference ``basic.hpp:84``)."""

    INGRESS = "ingress"
    EVENT = "event"


class WinType(enum.Enum):
    """Window domain (reference ``basic.hpp:80``): count- or time-based."""

    CB = "count"
    TB = "time"


class RoutingMode(enum.Enum):
    """How an emitter distributes outputs (reference ``basic.hpp:87``)."""

    NONE = "none"
    FORWARD = "forward"
    KEYBY = "keyby"
    BROADCAST = "broadcast"
    REBALANCING = "rebalancing"


class WindowRole(enum.Enum):
    """Role of a window stage inside the compound window operators
    (reference ``basic.hpp:219``): plain sequential, pane-level query,
    window-level query, map stage, reduce stage."""

    SEQ = "seq"
    PLQ = "plq"
    WLQ = "wlq"
    MAP = "map"
    REDUCE = "reduce"


@dataclasses.dataclass
class Config:
    """Runtime configuration (the reference's compile-time macro set as
    per-graph values)."""

    # Punctuation (watermark flush) cadence for idle emitters, microseconds
    # (reference default 100 ms, basic.hpp:195).
    punctuation_interval_usec: int = 100_000
    # Punctuation cadence in number of inputs; 0 disables the count trigger
    # (a punctuation flushes open staging batches).
    punctuation_amount: int = 0
    # Outstanding device batches per replica inbox before the scheduler
    # throttles source ticks (reference in-transit counter,
    # recycling_gpu.hpp:88-126).
    max_inflight_batches: int = 8
    # Queued messages per replica inbox before source throttling.
    max_inbox_messages: int = 8192
    # Tuples pulled from each live source per sweep; 0 = one staged batch.
    source_tick_chunk: int = 0
    # Messages one replica may process per sweep.
    sweep_drain_limit: int = 16
    # Extra source-tick passes per sweep after the drain phase, so batch
    # N+1 is packed on the host while the card runs batch N.
    stage_prefetch_depth: int = 1
    # Default device batch capacity (tuples a step) where a graph names
    # none: the capacity the IR audit's dry pass evaluates a user
    # function at when no upstream declares an output batch size.
    default_batch_size: int = 4096
    # FFAT batch grouping: "rank_scatter" (the counting permutation, and
    # the grouping kernel under its gate) or "argsort" (the stable
    # comparison sort; a declared monoid then takes the permutation path
    # too).  Both order by (key, arrival): the records are identical.
    # "argsort" sorts only where the grouping kernel cannot run (kernels
    # off, or a CPU graph): on CUDA with the kernels on, the kernel runs.
    ffat_grouping: str = os.environ.get("WF_TPU_FFAT_GROUPING",
                                        "rank_scatter")
    # Hand-written CUDA kernels on the FFAT and reduce paths
    # (windflow_tpu_torch/kernels): "auto" launches them for CUDA tensors and runs their plain
    # PyTorch versions for CPU tensors; "1" forces them on (the same
    # routing); "0" is the kill switch — the torch composition runs and
    # nothing is built.
    cuda_kernels: object = "auto"
    # Device-side key compaction (parallel/compaction.py): the graph
    # build attaches a KeyCompactor to every keyed declared-monoid
    # ReduceGPU (withMaxKeys: the bounded step, out-of-range keys ride
    # the sorted overflow lane and are kept; without it: a remap of
    # hot keys to dense slots, the cold tail on the overflow lane), to
    # host-fed interning stateful operators (the remap replaces the
    # per-batch intern read) and to withCompactedKeys windows.  Off,
    # nothing attaches: the dense reduce drops and counts out-of-range
    # keys, and a compacted window raises at its first batch.
    key_compaction: bool = True
    # Dense slots of a compacted reduce or window (the remap table's
    # size); stateful operators use their withNumKeySlots instead.
    key_compaction_slots: int = 1024
    # Reseed cadence in consumer batches: every N-th batch the compactor
    # reads its consumers' miss rings (one device read) and admits the
    # candidates into free slots.
    key_compaction_reseed: int = 64
    # Whole-chain fusion (windflow_tpu_torch/fusion): at graph build each
    # maximal run of stateless device operators (map / filter / chained)
    # ending in at most one window or reduce tail runs as ONE hop whose
    # step applies the members' record transforms ahead of the tail's own
    # step; the interior batches, emitters and queue hops go away.  Off,
    # every hop runs its own step (the JAX package's WF_TPU_FUSE=0).
    whole_chain_fusion: bool = True
    # Wire plane (windflow_tpu_torch/wire.py): "auto" compresses the packed
    # staging buffers of every edge with a declared or inferred record
    # spec exactly when the device is CUDA (decoded on the card in the
    # unpack); True/False force it either way.
    wire_compression: object = "auto"
    # Megastep plane (windflow_tpu_torch/megastep.py): K staged batches of
    # an eligible edge run as one group — one captured CUDA graph replay
    # on the card, an eager loop on the CPU.  "auto" is K = 8 on CUDA
    # and 1 (off) on the CPU; an integer forces K anywhere; K <= 1 is
    # the kill switch.
    megastep_sweeps: object = "auto"
    # Durable state (windflow_tpu_torch/durability): the directory holding
    # the graph's epoch-versioned checkpoint store.  Non-empty enables
    # watermark-aligned checkpointing: every `durability_epoch_sweeps`-th
    # scheduler sweep the graph quiesces (flush + drain to an
    # aligned barrier), commits exactly-once sink epochs (fenced Kafka
    # commit / atomic file rename), snapshots all operator state (FFAT
    # rings, stateful tables, reduce states, compactor remaps, Kafka
    # offsets, watermark frontiers) into the LogKV, and writes the epoch
    # manifest as the commit point.  A crashed graph rebuilds at the last
    # complete epoch through PipeGraph.restore().  "" is the kill switch:
    # the plane is never built and the sweep loop keeps one `is None`
    # check.
    durability: str = ""
    # Checkpoint cadence in logical sweeps (sweep-counted, not
    # wall-clock, so two runs of one graph over the same data place their
    # barriers at the same stream positions); under an active megastep
    # plane the build converts it to scheduler sweeps, ceil(eps / K)
    # (megastep.round_epoch_to_megastep).
    durability_epoch_sweeps: int = 64
    # Complete epochs retained in the checkpoint store; older epochs are
    # tombstoned (LogKV auto-compaction reclaims the log space).
    durability_keep: int = 2
    # Device the graph runs on.  The card is the default; without CUDA a
    # graph raises unless the caller asked for "cpu".
    device: str = "cuda"
    # Directory of stats dumps, Chrome traces and postmortem bundles
    # (PipeGraph.dump_stats / dump_trace / dump_postmortem).
    log_dir: str = "log"
    # Flight recorder (monitoring/recorder.py): per-batch span events of
    # one batch in `trace_sample_every` into preallocated per-replica
    # rings, and the staged→sunk latency histogram the sinks fill.  Off,
    # no recorder is built: every hook is one `is not None` check.
    flight_recorder: bool = True
    # 1-in-N batch sampling of the span traces (N = 1 traces every batch).
    trace_sample_every: int = 64
    # Span events retained over all the rings (split evenly; a full ring
    # overwrites its oldest events).
    trace_ring_events: int = 65536
    # Every M-th TRACED batch waits for its step's device work (a CUDA
    # event recorded after the step, then synchronized) to stamp
    # `device_done`: a real wait, 1 in (trace_sample_every * M) batches.
    # 0 never waits (spans end at `dispatched`).
    trace_device_sync_every: int = 8
    # torch.profiler capture directory of PipeGraph.profile ("" =
    # "{log_dir}/{name}_profile").
    profiler_dir: str = ""
    # Health plane (monitoring/health.py): a watchdog evaluated at stats
    # cadence derives OK / BACKPRESSURED / STALLED / FAILED per operator,
    # names the root cause of a stall, and feeds the postmortem bundle.
    # Off, no plane is built: every call site is one `is not None` check.
    health_watchdog: bool = True
    # An operator with pending input whose inputs and watermark frontier
    # have not moved for this long is STALLED (microseconds).
    health_stall_grace_usec: int = 5_000_000
    # Summed inbox depth at which a still-progressing operator is
    # BACKPRESSURED; 0 = max_inbox_messages // 2.
    health_backpressure_depth: int = 0
    # Recaptures (the registry's recompiles) of one operator's megastep
    # graph at which it is flagged as in a capture storm.
    health_recompile_storm: int = 4
    # Health state changes kept for the postmortem.
    health_history: int = 256
    # Postmortem bundle directory ("" = "{log_dir}/{name}_postmortem").
    health_postmortem_dir: str = ""
    # Write the postmortem bundle when wait_end crashes or the watchdog
    # confirms a stall.
    health_postmortem_on_crash: bool = True
    # Sweep ledger (monitoring/sweep_ledger.py): per-hop step dispatches
    # and tensor bytes a staged batch, read at stats cadence from the
    # step registry's counters.  Off leaves one check at each read site.
    sweep_ledger: bool = True
    # Shard plane (monitoring/shard_ledger.py): per-replica attribution
    # of the operator gauges and key-skew sketches on the keyed edges
    # (count-min + hot-key candidates, updated on the card inside the
    # keyby split and the fused chain step, read at stats cadence); the
    # compactors rank their residents by them.  Off attaches no sketch.
    shard_ledger: bool = True
    # Hot keys kept a keyed edge in stats()["Shard"].
    shard_topk: int = 8
    # The fields below keep the JAX package's WF_TPU_* environment knobs
    # and defaults.
    # Preflight (windflow_tpu_torch/analysis/preflight.py):
    # PipeGraph.start() runs PipeGraph.check() first, an abstract
    # evaluation of the whole graph on fake tensors with no device work.
    # "error" refuses the graph with the FULL list of error-severity
    # diagnostics (warnings are warned), "warn" downgrades every finding
    # to a warning, "off" skips the pass.
    preflight: str = os.environ.get("WF_TPU_PREFLIGHT", "error")
    # Host worker pool (reference: one OS thread per replica,
    # basic_operator.hpp:54-235): N > 0 drains host replicas on an
    # N-thread pool each sweep, one task a replica with work.  Sources,
    # device replicas, replicas not host_pool_safe and every replica on
    # an edge that carries device batches stay on the driver thread, so
    # a pool thread never touches the card (nor a CUDA graph capture).
    # Pure-Python per-tuple work is GIL-bound; GIL-releasing work
    # (numpy, native calls, blocking I/O) overlaps.  0 = the single
    # cooperative loop.
    host_worker_threads: int = int(os.environ.get("WF_TPU_HOST_WORKERS",
                                                  "0"))
    # Capture audit (analysis/ir_audit.py): the first step of each
    # device operator and each megastep capture run under a recording
    # dispatch mode, whose facts (host crossings, syncs, 64-bit dtypes,
    # data-dependent shapes, rebound in-place state, kernel launches)
    # read as WF902-WF907 in stats()["IR_audit"], the postmortem's
    # ir_audit.json and check()'s table.  0 is the kill switch: nothing
    # is recorded, one flag check on the cold first-step path.
    ir_audit: bool = bool(int(os.environ.get("WF_TPU_IR_AUDIT", "1")))
    # Key-aligned mesh ingest (parallel/emitters.AlignedMeshStageEmitter
    # and the sharded steps' ingest="aligned"): a host-fed key-sharded
    # consumer with a declared dense key space takes its batches
    # pre-placed on the owning key shard's column, so its step skips the
    # data-axis all_gather (and the reduce's cross-shard table combine).
    # WF_TPU_KEY_ALIGNED=0 keeps the data-sharded ingest everywhere.
    key_aligned_ingest: bool = bool(int(os.environ.get(
        "WF_TPU_KEY_ALIGNED", "1")))
    # Dashboard endpoint (reference WF_DASHBOARD_MACHINE/PORT) of the
    # monitoring thread (monitoring/monitor.py).
    dashboard_host: str = os.environ.get("WF_TPU_DASHBOARD_HOST",
                                         "localhost")
    dashboard_port: int = int(os.environ.get("WF_TPU_DASHBOARD_PORT",
                                             "20207"))
    # run() starts a MonitoringThread (monitoring/monitor.py): gauges and
    # health at cadence, reports shipped to the dashboard, stats dumped
    # at the end (reference -DWF_TRACING_ENABLED).
    tracing_enabled: bool = bool(int(os.environ.get("WF_TPU_TRACING", "0")))
    # Latency ledger (monitoring/latency_ledger.py): the flight
    # recorder's traces decomposed into five staged→sunk segments per
    # operator, harvested at cadence; needs the flight recorder.  Off,
    # no ledger is built: each call site is one `is not None` check.
    latency_ledger: bool = bool(int(os.environ.get("WF_TPU_LATENCY", "1")))
    # End-to-end p99 budget in milliseconds (0 = no SLO): over it, the
    # ledger latches SLO_VIOLATED on the dominant operator.
    latency_slo_ms: float = float(os.environ.get("WF_TPU_LATENCY_SLO_MS",
                                                 "0"))
    # Tenant label of this graph's telemetry ("" = the graph's name).
    tenant: str = os.environ.get("WF_TPU_TENANT", "")
    # Tenant plane (monitoring/tenant_ledger.py): the graph registers in
    # the process tenant ledger, which attributes dispatches, captures,
    # staged bytes and resident device bytes to tenants at cadence.
    tenant_ledger: bool = bool(int(os.environ.get("WF_TPU_TENANT_LEDGER",
                                                  "1")))
    # Per-tenant budget of resident device bytes (0 = none): sustained
    # overage latches OVER_BUDGET on the tenant's heaviest operator.
    hbm_budget_bytes: int = int(os.environ.get(
        "WF_TPU_HBM_BUDGET_BYTES", "0"))
    # Calibration store (monitoring/calibration.py): the path of a
    # calibration.json written by `python -m
    # windflow_tpu_torch.monitoring.calibrate`; its probe-measured
    # constants replace the modeled defaults while fresh and recorded on
    # this device.  WF_TPU_CALIBRATION=0 is the kill switch.
    calibration: str = os.environ.get("WF_TPU_CALIBRATION", "")
    # Live roofline plane (monitoring/calibration.RooflineLedger):
    # per-hop achieved tuples/s at cadence against the memory
    # bandwidth's ceiling, and the advisory ROOFLINE_DEGRADED verdict.
    roofline_plane: bool = bool(int(os.environ.get("WF_TPU_ROOFLINE",
                                                   "1")))
    # Reshard executor (windflow_tpu_torch/serving): health-plane
    # BACKPRESSURED/STALLED verdicts or sustained imbalance drive the
    # reshard advisor's plans on the live graph: move_keys (quiesce,
    # re-place the key→shard override, keyed state moved with the keys,
    # resume), split_hot_key as a pre-aggregating partial combine at the
    # keyed staging boundary, and admission control at the sources when
    # no plan helps.  Off by default (it mutates routing); off leaves one
    # `is not None` check a sweep.
    reshard_executor: bool = bool(int(os.environ.get("WF_TPU_RESHARD",
                                                     "0")))
    # Executor tick cadence in scheduler sweeps, and the state machine's
    # thresholds: bad ticks before a plan applies, good ticks before an
    # applied plan counts as recovered (and admission backs off).
    reshard_check_sweeps: int = int(os.environ.get(
        "WF_TPU_RESHARD_CHECK_SWEEPS", "32"))
    reshard_trigger_ticks: int = int(os.environ.get(
        "WF_TPU_RESHARD_TRIGGER_TICKS", "2"))
    reshard_ok_ticks: int = int(os.environ.get(
        "WF_TPU_RESHARD_OK_TICKS", "4"))
    # Imbalance ratio (max shard load over the mean, on the window since
    # the last tick) above which an operator counts as degraded.
    reshard_imbalance_threshold: float = float(os.environ.get(
        "WF_TPU_RESHARD_IMBALANCE", "1.25"))
    # Sustained-OK ticks before the least-loaded shard's known keys
    # drain onto its siblings; 0 records the candidate without acting.
    reshard_scale_down_ticks: int = int(os.environ.get(
        "WF_TPU_RESHARD_SCALE_DOWN_TICKS", "0"))
    # Multi-GPU execution: a ``parallel.mesh.Mesh``, a ("data", "key")
    # grid of torch devices (parallel/mesh.make_mesh; one device may
    # repeat, a logical mesh on one card).  When set, staged batch
    # capacities must divide over the mesh's positions and the mesh-aware
    # device operators (FfatWindowsGPU, ReduceGPU, the stateful
    # Map/Filter) run their sharded steps: key-sharded state, one local
    # step per position, collectives between the phases.  Fusion and
    # the megastep skip mesh operators.
    mesh: object = None


#: Process-wide default configuration; graphs copy it at construction.
default_config = Config()


class WindFlowError(RuntimeError):
    """Raised for user/API misuse."""


#: Sentinel key of non-keyed stateful operators (reference ``empty_key_t``,
#: basic.hpp:306-318).
EMPTY_KEY = 0


def stable_hash(key) -> int:
    """Deterministic key hash of the host KEYBY edge (reference
    ``std::hash``, ``keyby_emitter.hpp:216``).  Python's ``hash`` is salted
    for str/bytes, so those take crc32 and placement stays the same from
    process to process."""
    if isinstance(key, int):
        return key
    if isinstance(key, str):
        return zlib.crc32(key.encode())
    if isinstance(key, bytes):
        return zlib.crc32(key)
    return hash(key)


def int32_key(k) -> int:
    """Wrap a numeric key to the int32 value the device state collapses to
    (device key extractors are cast to int32 on the card).  Keyed routing
    must collapse exactly the keys the state collapses, or one logical key
    would straddle replicas."""
    i = int(k) & 0xFFFFFFFF
    return i - (1 << 32) if i >= (1 << 31) else i


def resolve_device(config) -> "object":
    """The ``torch.device`` a graph runs on.  Never falls back: a CUDA
    device without CUDA present raises."""
    import torch
    dev = torch.device(getattr(config, "device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise WindFlowError(
            "Config.device is 'cuda' but CUDA is not available; pass "
            "Config(device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise WindFlowError(f"unsupported device {dev}")
    return dev


def current_time_usecs() -> int:
    """Wall clock in microseconds (reference ``current_time_usecs``)."""
    return time.time_ns() // 1_000
