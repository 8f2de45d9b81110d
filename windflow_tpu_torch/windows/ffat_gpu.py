"""FfatWindowsGPU: incremental sliding windows on the card (the port of
``windflow_tpu/windows/ffat_tpu.py``; reference ``Ffat_Windows_GPU``,
``ffat_replica_gpu.hpp:424``).

Windows of length W sliding by S decompose into panes of P = gcd(W, S):
R = W/P panes per window, fired every D = S/P panes.

* Count-based windows keep per-key state dense over a static key space
  ``[0, max_keys)``: a carry of the trailing R-1 pane aggregates per key
  plus the current partial pane (``ffat_kernels.make_ffat_state``).  One
  step emits every window it completes, across all keys, as one
  compacted output batch.
* Time-based windows use quantum panes — pane = ``ts // P`` µs — over a
  rolling ring of NP panes per key with watermark-driven firing
  (``ffat_kernels.make_ffat_tb_step``).  The ring is sized at the first
  batch unless ``withPaneCapacity`` fixes it, grows ahead of the
  capacity roll from the host-known batch extrema (``_regrow_for_span``)
  and, as a backstop, when panes were evicted (``_maybe_regrow``, one
  late counter read every 32 steps).  Late tuples, evicted pane cells
  and suppressed windows are counted; the overflow policy decides what
  an eviction does.  The step itself never reads the device on the host;
  the first batch's ring sizing, the 32-step checkpoint and EOS do.

Keyed at parallelism > 1 (the keyed emitters route each key to one
replica): TB state is kept per replica (``_states`` by ``_sidx``: each
partition has its own watermark frontier), CB state is shared (index 0)
and the replicas step it one after another on the one stream, as the JAX
package does.  As the tail of a fused segment the step applies the
members' prelude first (``_build_step``; a ring regrow rebuilds it with
the prelude) and the aggregate state is sized from the post-prelude
records.  The TB ring's first sizing reads the batch the operator is
handed, as the JAX package does: fused, that is the mask BEFORE the
prelude's filters, so the ring may differ in size from the unfused
run's; the records do not.

Compacted keys (``withCompactedKeys``, ``max_keys=None``): the graph
build attaches a pinned ``KeyCompactor`` (``parallel/compaction.py``)
and ``max_keys`` becomes its slot count.  The step looks each lane's
key up in the compactor's tables (``lookup_slots``), runs the window
kernels over ``{"rec": record, "slot": slot}`` lanes keyed by the slot,
counts hits and misses (``cstats_update``; unadmitted keys are masked
and counted) and maps the output key lane back to the user's keys
(``slots_to_user_keys``), at EOS too.  A compacted window has no
lossless fallback: once its host admission path died the next step
raises.  Compacted windows do not fuse (their keys are admitted at the
host staging boundary).  ``snapshot_state``/``restore_state`` carry
the rings across a checkpoint in the JAX package's blob layout.

On a mesh (``Config.mesh``, ``parallel/mesh.py``) the state is key-sharded
(a ``Sharded`` value: each position holds its key shard's rows and, for
time windows, its own ring clock) and the step is
``make_sharded_ffat_step`` / ``make_sharded_ffat_tb_step``, whose
per-shard local steps are this module's factories with a key base.  The
batch ingest is ``"data"`` in one process, ``"flat"`` across processes
and ``"aligned"`` where the graph build stamped key-aligned ingest.
Ring growth and rebase act on every shard's block; a multi-process run
(``torch.distributed`` world size > 1) skips the span regrow (each
process sees different extrema).  A
checkpoint holds the assembled global layout (the TB clocks as one lane
a key shard), re-sharded on restore for the restoring mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from windflow_tpu_torch.basic import RoutingMode, WindFlowError, WinType
from windflow_tpu_torch.batch import WM_NONE, DeviceBatch
from windflow_tpu_torch.fusion.executor import prelude_out_payload
from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.gpu import _GPUReplica
from windflow_tpu_torch.utils.tree import per_record, tree_map
from windflow_tpu_torch.windows.engine import WindowSpec
from windflow_tpu_torch.windows.ffat_kernels import (agg_spec_for,
                                                     make_ffat_flush,
                                                     make_ffat_state,
                                                     make_ffat_step,
                                                     make_ffat_tb_state,
                                                     make_ffat_tb_step,
                                                     resolve_monoid)

#: steps between the TB ring's host checkpoints (regrow, error policy)
CHECK_EVERY = 32


class FfatGPUReplica(_GPUReplica):
    def _op_step(self, batch: DeviceBatch):
        return self.op._step(batch, self.index)

    def on_eos(self):
        op = self.op
        if op.is_tb and op._per_replica_state:
            # keyed TB: each replica owns its partition's ring and clock
            outs = op._flush_tb(self.index)
        else:
            # one shared state: only the LAST replica to terminate may
            # flush it (a sibling may still hold batches for it)
            op._eos_replicas += 1
            if op._eos_replicas < op.parallelism:
                return
            outs = op._flush_tb(0) if op.is_tb else op._flush()
        for out in outs:
            op.watch.note()
            self.stats.device_programs_launched += 1
            self.stats.outputs_sent += out.size
            self.emitter.emit_device_batch(out)


class _LateRead:
    """A device count read one checkpoint late: the copy to the host is
    enqueued now and the value taken at the next checkpoint, by when the
    stream has run far past it, so reading it never waits on the steps
    enqueued since."""

    def __init__(self, t: torch.Tensor) -> None:
        self._done = None
        if t.device.type == "cuda":
            self._host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host = t.clone()

    def value(self) -> int:
        if self._done is not None:
            self._done.synchronize()
        return int(self._host)  # wfverify: ok (the checkpoint read)


class FfatWindowsGPU(Operator):
    replica_class = FfatGPUReplica
    fixed_capacity_label = "FfatWindowsGPU"

    def __init__(self, lift: Callable, comb: Callable, spec: WindowSpec, *,
                 max_keys: int, name: str = "ffat_windows_gpu",
                 parallelism: int = 1,
                 key_extractor: Optional[Callable] = None,
                 pane_capacity: Optional[int] = None,
                 overflow_policy: str = "drop",
                 monoid: Optional[str] = None) -> None:
        routing = (RoutingMode.KEYBY if key_extractor is not None
                   else RoutingMode.FORWARD)
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        if max_keys is None and key_extractor is None:
            raise WindFlowError(
                f"FfatWindowsGPU '{name}': a compacted key space "
                "(withCompactedKeys) requires withKeyBy — non-keyed "
                "windows use withMaxKeys(1)")
        if max_keys is not None and max_keys < 1:
            raise WindFlowError(
                f"FfatWindowsGPU '{name}': withMaxKeys(n >= 1) is required")
        self.lift = lift
        self.comb = comb
        self.spec = spec
        self.max_keys = max_keys
        self.P = math.gcd(spec.win_len, spec.slide)
        self.R = spec.win_len // self.P
        self.D = spec.slide // self.P
        self.is_tb = spec.win_type == WinType.TB
        # TB ring contract: the window span, plus the time spread of one
        # batch, plus the lateness allowance in panes; past it panes are
        # evicted and counted.  None: auto-sized at the first batch.
        self.NP = pane_capacity
        if self.is_tb and pane_capacity is not None \
                and pane_capacity < 2 * self.R:
            # >= 2R also lets the two pre-place fire passes reach every
            # window over in-ring data (ffat_kernels.make_ffat_tb_step)
            raise WindFlowError(
                "pane_capacity must be at least 2*win/gcd panes")
        if self.is_tb and key_extractor is None and parallelism > 1:
            # round-robin replicas would place batches into the shared
            # ring in drain order, not arrival order
            raise WindFlowError(
                "non-keyed time-based FfatWindowsGPU requires "
                "parallelism == 1; use withKeyBy to scale")
        if overflow_policy not in ("drop", "count", "error"):
            raise WindFlowError(
                f"unknown overflow policy '{overflow_policy}' "
                "(drop | count | error)")
        #: TB ring overflow: "drop" suppresses windows that lost data
        #: panes and counts them; "count" fires them over the surviving
        #: panes (wrong aggregates, evictions counted); "error" raises at
        #: the next host checkpoint
        self.overflow_policy = overflow_policy
        try:
            self.monoid = resolve_monoid(monoid)
        except ValueError as e:
            raise WindFlowError(str(e)) from None
        self._overflow_steps = 0
        self._auto_np = False          # NP chosen by the span estimator
        self._np_ceil = None
        self._evicted_seen = 0         # n_evicted at the last regrow check
        self._pending_evct = None      # late counter read (one cadence old)
        self._evicted_base = 0         # evictions excused as regrow pains
        self._error_armed = False      # error policy live (post-transient)
        self._clean_checks = 0
        self._dirty_checks = 0
        # data-ts extrema seen while the multi-channel watermark fold is
        # unresolved (frontier == WM_NONE): nothing fires then, so the
        # ring must cover this spread (_regrow_for_span)
        self._unres_lo = None
        self._unres_hi = None
        # True once a step ran with a resolved frontier: until then the
        # ring may be rebased down (_rebase_ring)
        self._fold_stepped = False
        # device state by state index: CB one shared table (index 0);
        # TB one ring per keyed replica (_sidx)
        self._states = {}
        self._step_fn = None
        self._capacity = None
        self._payload_zero = None      # all-invalid batch for the TB flush
        self._flushed = False
        self._eos_replicas = 0
        #: compaction stats of a compacted key space (device tensors)
        self._cstats = None

    def key_space(self):
        # the dense pane state bounds the key space where the step does; a
        # compacted key space is unbounded to routing (only the state is
        # slot-dense)
        if self._compactor is not None:
            return None
        return self.max_keys if self.key_extractor is not None else None

    def enable_compaction(self, comp) -> None:
        """Attach a pinned KeyCompactor (graph build): ``max_keys`` becomes
        the slot bound, and the pane state stays dense over the slots."""
        self._compactor = comp
        self.max_keys = comp.slots
        comp.register_device_stats(lambda: self._cstats)

    # -- per-batch program ---------------------------------------------------
    def _build_step(self, capacity: int):
        # the kernel switch resolves once per step build
        kernels = resolve_kernels(self.config)
        if self.mesh is not None:
            return self._build_mesh_step(capacity, kernels)
        lift, key_fn = self.lift, self.key_extractor
        if self._compactor is not None:
            # the kernels see {"rec": record, "slot": slot} lanes keyed by
            # the slot the wrapper (_compacted) looked up
            user_lift = self.lift
            lift = lambda r: user_lift(r["rec"])  # noqa: E731
            key_fn = lambda r: r["slot"]          # noqa: E731
        if self.is_tb:
            step = make_ffat_tb_step(
                capacity, self.max_keys, self.P, self.R, self.D, self.NP,
                lift, self.comb, key_fn,
                drop_tainted=self.overflow_policy == "drop",
                monoid=self.monoid, kernels=kernels,
                grouping=self._grouping())
        else:
            step = make_ffat_step(capacity, self.max_keys, self.P, self.R,
                                  self.D, lift, self.comb, key_fn,
                                  monoid=self.monoid, kernels=kernels,
                                  grouping=self._grouping())
        if self._compactor is not None:
            step = self._compacted(step)
        prelude = self._fused_prelude
        if prelude is None:
            return step
        inner = step

        def step(state, payload, ts, valid, *rest):
            # whole-chain fusion: the segment's stateless members run
            # first, inside this step (fusion/executor.py)
            payload, valid = prelude(payload, valid)
            return inner(state, payload, ts, valid, *rest)
        return step

    def _build_mesh_step(self, capacity: int, kernels: bool):
        """The sharded step (parallel/mesh.py): ``capacity`` is the
        staged batch's, which holds this process's lanes; the step lays
        out the global batch of every process's lanes."""
        from windflow_tpu_torch.parallel import mesh as M
        from windflow_tpu_torch.parallel.multihost import process_count
        nproc = process_count()
        ingest = getattr(self, "_ingest_mode", None) \
            or ("flat" if nproc > 1 else "data")
        gcap = capacity * nproc
        if self.is_tb:
            return M.make_sharded_ffat_tb_step(
                self.mesh, gcap, self.max_keys, self.P, self.R, self.D,
                self.NP, self.lift, self.comb, self.key_extractor,
                drop_tainted=self.overflow_policy == "drop",
                grouping=self._grouping(), ingest=ingest,
                monoid=self.monoid, kernels=kernels,
                op_name=f"{self.name}.mesh")
        return M.make_sharded_ffat_step(
            self.mesh, gcap, self.max_keys, self.P, self.R, self.D,
            self.lift, self.comb, self.key_extractor, monoid=self.monoid,
            grouping=self._grouping(), ingest=ingest, kernels=kernels,
            op_name=f"{self.name}.mesh")

    # -- mesh state helpers ----------------------------------------------------
    def _map_state(self, st, fn):
        """``fn`` over one state's blocks (every mesh position's, or the
        single-device state itself)."""
        from windflow_tpu_torch.parallel.mesh import Sharded
        if isinstance(st, Sharded):
            return Sharded(st.mesh, st.spec,
                           {p: fn(b) for p, b in st.blocks.items()})
        return fn(st)

    def _shard_row(self, st) -> list:
        """One block a key shard (data row 0 of a mesh state: the data
        rows hold equal state), or the single-device state."""
        from windflow_tpu_torch.parallel.mesh import Sharded
        if isinstance(st, Sharded):
            d0 = st.mesh.local_positions[0][0]
            return [b for (d, _), b in sorted(st.blocks.items())
                    if d == d0]
        return [st]

    def _state_sum(self, name: str) -> torch.Tensor:
        """A TB counter summed over the states and their key shards, as
        one device scalar (no host read)."""
        parts = [b[name] for st in self._states.values()
                 for b in self._shard_row(st)]
        home = parts[0].device
        return sum(p.to(home) for p in parts)

    def _grouping(self) -> str:
        """``Config.ffat_grouping`` (rank_scatter | argsort), checked at
        step build."""
        mode = getattr(self.config, "ffat_grouping", "rank_scatter")
        if mode not in ("rank_scatter", "argsort"):
            raise WindFlowError(
                f"unknown ffat_grouping '{mode}' (rank_scatter | argsort)")
        return mode

    def _compacted(self, kernel):
        """Wrap a window step for a compacted key space: ``(state,
        payload, ts, valid, *args, table_keys, table_slots, cstats) ->
        (*outs, cstats')``, the output key lane mapped back to user keys."""
        from windflow_tpu_torch.parallel import compaction
        user_key = self.key_extractor

        def step(state, payload, ts, valid, *rest):
            *kargs, tk, tsl, cst = rest
            raw = per_record(user_key, payload,
                             int(valid.shape[0])).to(torch.int32)
            slots, hit = compaction.lookup_slots(tk, tsl, raw, valid)
            cst = compaction.cstats_update(cst, raw, hit, valid & ~hit)
            outs = kernel(state, {"rec": payload, "slot": slots}, ts,
                          valid & hit, *kargs)
            out = dict(outs[1])
            out["key"] = compaction.slots_to_user_keys(out["key"], tk, tsl)
            return (outs[0], out) + tuple(outs[2:]) + (cst,)
        return step

    @property
    def _per_replica_state(self) -> bool:
        # the ring clock is shared by a state's keys: keyed partitions
        # (independent watermark frontiers) need one state each
        return self.is_tb and self.routing == RoutingMode.KEYBY \
            and self.parallelism > 1

    def _sidx(self, ridx: int) -> int:
        return ridx if self._per_replica_state else 0

    def _ensure(self, batch: DeviceBatch, sidx: int) -> None:
        if self._capacity is None:
            if self.max_keys is None:
                raise WindFlowError(
                    f"FfatWindowsGPU '{self.name}': compacted key space "
                    "(withCompactedKeys) needs Config.key_compaction on "
                    "and a graph build to assign slots; declare "
                    "withMaxKeys to run without compaction")
            self._capacity = batch.capacity
            self._size_ring(batch)
            if self.is_tb:
                self._payload_zero = tree_map(torch.zeros_like,
                                              batch.payload)
            self._step_fn = self._build_step(batch.capacity)
        elif batch.capacity != self._capacity:
            raise WindFlowError(
                "FfatWindowsGPU requires a fixed upstream batch capacity "
                f"({self._capacity}), got {batch.capacity}")
        if sidx not in self._states:
            payload = batch.payload
            if self._fused_prelude is not None:
                # fused: the lift sees the prelude's OUTPUT records
                payload = prelude_out_payload(self._fused_prelude, payload,
                                              batch.valid)
            spec = agg_spec_for(self.lift, payload)
            dev = batch.valid.device
            if self.mesh is not None:
                from windflow_tpu_torch.parallel import mesh as M
                self._states[sidx] = (
                    M.make_sharded_ffat_tb_state(spec, self.max_keys,
                                                 self.NP, self.mesh)
                    if self.is_tb else
                    M.make_sharded_ffat_state(spec, self.max_keys, self.R,
                                              self.mesh))
                return
            self._states[sidx] = (
                make_ffat_tb_state(spec, self.max_keys, self.NP, device=dev)
                if self.is_tb else
                make_ffat_state(spec, self.max_keys, self.R, device=dev))

    def _size_ring(self, batch: DeviceBatch) -> None:
        """The ring's memory ceiling, and its size when not fixed by
        ``withPaneCapacity``: from the FIRST batch's observed time spread
        (one host read, once), 8x its pane span plus the lateness
        allowance, floored at 2R / R+64 and capped at the ceiling.  The
        ceiling bounds the dense [max_keys, NP] state; the lateness panes
        are added because lateness pins panes in the ring.  Count windows
        keep no ring; they record the ceiling as ``NP``, as the JAX
        package does, so the two packages' checkpoint blobs agree."""
        R, P = self.R, self.P
        cap_by_mem = max(64, (1 << 23) // max(1, self.max_keys))
        lat_panes = self.spec.lateness // P + 1 if self.is_tb else 0
        self._np_ceil = max(2 * R, R + 64,
                            R + lat_panes + min(8192, cap_by_mem) + 2)
        if self.NP is not None:
            return
        if not self.is_tb:
            self.NP = self._np_ceil
            return
        # wfverify: ok (the TB ring's first sizing: one read, once)
        tmin, tmax = torch.stack([
            torch.where(batch.valid, batch.ts, 1 << 62).min(),
            torch.where(batch.valid, batch.ts, -(1 << 62)).max()]).tolist()
        span = (tmax - tmin) // P + 1 if tmax >= tmin else 1
        est = 8 * span + lat_panes + R + 2
        self.NP = max(2 * R, R + 64, min(est, self._np_ceil))
        self._auto_np = True

    def _run_step(self, sidx: int, payload, ts, valid, *args):
        comp = self._compactor
        if comp is None:
            outs = self._step_fn(self._states[sidx], payload, ts, valid,
                                 *args)
            self._states[sidx] = outs[0]
            return outs[1:]
        if not comp.active:
            # no lossless fallback (max_keys bounds the SLOT space):
            # running on would mask every key not admitted yet
            raise WindFlowError(
                f"FfatWindowsGPU '{self.name}': the compacted key space "
                "lost its host admission path (the key extractor failed "
                "on the staging probe, or admission errored) — declare "
                "withMaxKeys or make the extractor batch-applicable")
        from windflow_tpu_torch.parallel import compaction
        comp.on_batch()
        if self._cstats is None:
            self._cstats = compaction.cstats_init(valid.device)
        tk, tsl = comp.tables()
        outs = self._step_fn(self._states[sidx], payload, ts, valid, *args,
                             tk, tsl, self._cstats)
        self._states[sidx] = outs[0]
        self._cstats = outs[-1]
        return outs[1:-1]

    def _wm_pane(self, wm: int) -> int:
        """Lateness-adjusted watermark in panes: the firing frontier the
        step compares window ends against."""
        if wm == WM_NONE:
            return -(1 << 60)
        return (wm - self.spec.lateness) // self.P

    def _step(self, batch: DeviceBatch, ridx: int = 0) -> DeviceBatch:
        sidx = self._sidx(ridx)
        self._ensure(batch, sidx)
        if not self.is_tb:
            out, fired, out_ts = self._run_step(sidx, batch.payload, batch.ts,
                                                batch.valid)
            return DeviceBatch(out, out_ts, fired,
                               watermark=batch.watermark, size=None)
        if self._auto_np:
            # also at the ceiling: the extrema tracking and the pre-fold
            # rebase must still run
            self._regrow_for_span(batch)
        if batch.frontier != WM_NONE:
            self._fold_stepped = True
        # fire on the batch's staging-time frontier: the step places every
        # tuple of the batch before it fires
        out, fired, out_ts, _ = self._run_step(
            sidx, batch.payload, batch.ts, batch.valid,
            self._wm_pane(batch.frontier))
        self._overflow_steps += 1
        if self._overflow_steps % CHECK_EVERY == 0:
            if self._auto_np:
                self._maybe_regrow()
            if self.overflow_policy == "error":
                self._check_overflow()
        return DeviceBatch(out, out_ts, fired, watermark=batch.watermark,
                           size=None)

    # -- EOS -------------------------------------------------------------------
    def _flush(self) -> list:
        """EOS flush of the CB shared state: fire the remaining partial
        windows (reference EOS flush of open windows)."""
        if not self._states or self._flushed:
            return []
        self._flushed = True
        if self.mesh is not None:
            from windflow_tpu_torch.parallel.mesh import \
                make_sharded_ffat_flush
            flush = make_sharded_ffat_flush(self.mesh, self.max_keys,
                                            self.P, self.R, self.D,
                                            self.comb)
        else:
            flush = make_ffat_flush(self.max_keys, self.P, self.R, self.D,
                                    self.comb)
        out, fired, ts = flush(self._states[0])
        if self._compactor is not None:
            # partial windows fired at EOS carry slots too
            from windflow_tpu_torch.parallel.compaction import \
                slots_to_user_keys
            out = dict(out)
            out["key"] = slots_to_user_keys(out["key"],
                                            *self._compactor.tables())
        return [DeviceBatch(out, ts, fired, watermark=0, size=None)]

    def _flush_tb(self, ridx: int) -> list:
        """EOS flush of one TB state: the step again, on an empty batch
        under an infinite watermark, until the window frontier stops
        advancing (looping on advance, not emission: windows beyond an
        empty gap would stall behind a pass that emits nothing)."""
        sidx = self._sidx(ridx)
        if sidx not in self._states:
            return []
        if self.overflow_policy == "error":
            self._check_overflow()
        dev = self._shard_row(self._states[sidx])[0]["base"].device \
            if self.mesh is None else self.mesh.home
        ts0 = torch.zeros(self._capacity, dtype=torch.int64, device=dev)
        invalid = torch.zeros(self._capacity, dtype=torch.bool, device=dev)
        outs = []
        while True:
            out, fired, out_ts, n_adv = self._run_step(
                sidx, self._payload_zero, ts0, invalid, 1 << 60)
            if bool(fired.any()):
                outs.append(DeviceBatch(out, out_ts, fired, watermark=0,
                                        size=None))
            if int(n_adv) == 0:  # wfverify: ok (the EOS flush's read)
                break
        return outs

    # -- ring growth -------------------------------------------------------------
    def _maybe_regrow(self) -> None:
        """Backstop growth of an auto-sized ring: if panes were evicted
        since the last check, quadruple it (up to the ceiling).  Evicted
        panes are gone (the overflow policy handled their windows);
        growth stops further loss.  The eviction count is read one
        checkpoint late (``_LateRead``), so a healthy step never waits."""
        if self.NP >= self._np_ceil or not self._states:
            return
        prev = self._pending_evct
        self._pending_evct = _LateRead(self._state_sum("n_evicted"))
        if prev is None:
            return
        ev = prev.value()
        if ev <= self._evicted_seen:
            return
        self._evicted_seen = ev
        # x4: the late read grows at most once per two checkpoints
        self._grow_ring(min(self._np_ceil, max(self.NP * 4, self.NP + 64)))

    def _grow_ring(self, new_np: int) -> None:
        """Pad every live ring to ``new_np`` panes (invalid columns) and
        rebuild the step."""
        pad = new_np - self.NP
        if pad <= 0:
            return

        def grow(st):
            out = dict(st)
            out["cells"] = tree_map(
                lambda a: torch.cat([a, a.new_zeros(
                    (a.shape[0], pad) + tuple(a.shape[2:]))], 1),
                st["cells"])
            out["cell_valid"] = torch.cat(
                [st["cell_valid"],
                 st["cell_valid"].new_zeros((st["cell_valid"].shape[0],
                                             pad))], 1)
            return out

        self._states = {k: self._map_state(st, grow)
                        for k, st in self._states.items()}
        self.NP = new_np
        self._pending_evct = None
        self._step_fn = self._build_step(self._capacity)
        if self.NP >= self._np_ceil:
            # at the ceiling: evictions so far were the estimator's
            # growing pains; the error policy counts from here
            self._evicted_base = self._tb_counter("n_evicted")

    def _rebase_ring(self, lo_pane: int, hi_pane: int) -> None:
        """Move the ring window DOWN to ``lo_pane`` so panes the capacity
        roll slid past while the watermark fold was unresolved become
        placeable again.  Safe only while nothing has fired: the slid-past
        columns are empty, and ``win_next``/``max_seen``/``horizon`` are
        absolute pane stamps.  One host read of ``base`` per state, at
        growth cadence only."""
        if self._fold_stepped:
            return
        for sidx, st in self._states.items():
            # a mesh's per-shard clocks advance in lockstep from the same
            # gathered batches: shard 0's base stands for every shard
            base = int(self._shard_row(st)[0]["base"])
            new_base = max(lo_pane, hi_pane - self.NP + 1)
            delta = base - new_base
            if delta <= 0:
                continue

            def rebase(b):
                out = dict(b)
                out["cells"] = tree_map(lambda a: torch.roll(a, delta, 1),
                                        b["cells"])
                out["cell_valid"] = torch.roll(b["cell_valid"], delta, 1)
                out["base"] = b["base"] - delta
                return out
            self._states[sidx] = self._map_state(st, rebase)

    def _regrow_for_span(self, batch: DeviceBatch) -> None:
        """Preemptive growth from host metadata alone.  By the watermark
        contract the ring needs the panes in ``(wm_adj, ts_max]`` plus
        R-1 of history, and at least the batch's own pane spread (one
        step's passes advance at most ``3 * (NP // D + 2)`` windows);
        growing to that before the step means the capacity roll never
        evicts data that is not late.  While the watermark fold is
        unresolved nothing fires, so the ring covers the observed spread
        (geometric growth), and a lagging channel's panes below the ring
        are recovered by a rebase before the first firing."""
        if batch.ts_max is None:
            return
        from windflow_tpu_torch.parallel import multihost
        if multihost.process_count() > 1:
            # each process sees its own lanes' extrema: growth decided
            # from them would desynchronize the sharded ring shapes; the
            # eviction-cadence regrow stays the growth path
            return
        P, R = self.P, self.R
        wm = batch.frontier
        if wm == WM_NONE:
            lo = batch.ts_min if batch.ts_min is not None else batch.ts_max
            prev_lo = self._unres_lo
            if self._unres_lo is None or lo < self._unres_lo:
                self._unres_lo = lo
            if self._unres_hi is None or batch.ts_max > self._unres_hi:
                self._unres_hi = batch.ts_max
            needed = (self._unres_hi - self._unres_lo) // P + R + 2
            if needed > self.NP:
                self._grow_ring(min(self._np_ceil,
                                    max(needed, self.NP * 2)))
            if prev_lo is not None and lo < prev_lo:
                self._rebase_ring(self._unres_lo // P, self._unres_hi // P)
            return
        lo = self._wm_pane(wm)          # oldest pane still open for data
        hi = batch.ts_max // P          # newest pane this batch touches
        if self._unres_hi is not None:
            if lo > self._unres_hi // P:
                self._unres_lo = self._unres_hi = None
            else:
                hi = max(hi, self._unres_hi // P)
        rebase_lo = None
        if not self._fold_stepped:
            # the first resolved batch: re-cover down to the oldest of its
            # rows and the pre-fold extrema before it places
            cand = [lo]
            if batch.ts_min is not None:
                cand.append(batch.ts_min // P)
            if self._unres_lo is not None:
                cand.append(self._unres_lo // P)
            rebase_lo = min(cand)
        needed = hi - lo + R + 2
        if batch.ts_min is not None:
            needed = max(needed, (batch.ts_max - batch.ts_min) // P + 1
                         + R + 2)
        if rebase_lo is not None:
            needed = max(needed, hi - rebase_lo + R + 2)
        if needed > self.NP:
            # at least double: each growth rebuilds the step
            self._grow_ring(min(self._np_ceil, max(needed, self.NP * 2)))
        if rebase_lo is not None:
            self._rebase_ring(rebase_lo, hi)

    # -- durable state (windflow_tpu_torch/durability) -----------------------
    def snapshot_state(self):
        """All cross-batch state, in the JAX package's blob layout
        (``windflow_tpu/windows/ffat_tpu.py`` ``snapshot_state``): the
        pane rings/tables per state index as numpy copies, the
        capacity/ring-size pair the step is rebuilt from, the
        regrow/overflow estimator bookkeeping, and the compactor's remap
        of a compacted key space.  A fused tail needs nothing extra:
        restore rebuilds the step through ``_build_step``, which applies
        the prelude again."""
        if not self._states:
            return None     # never stepped: nothing to restore
        from windflow_tpu_torch.parallel.mesh import Sharded
        from windflow_tpu_torch.utils.tree import host_copy
        return {
            "kind": "ffat_tpu",
            # a mesh state in its assembled global layout (key rows
            # concatenated, TB clocks one lane a key shard)
            "states": {k: host_copy(st.full() if isinstance(st, Sharded)
                                    else st)
                       for k, st in self._states.items()},
            "capacity": self._capacity,
            "NP": self.NP,
            "auto_np": self._auto_np,
            "np_ceil": self._np_ceil,
            "overflow_steps": self._overflow_steps,
            "evicted_seen": self._evicted_seen,
            "evicted_base": self._evicted_base,
            "error_armed": self._error_armed,
            "clean_checks": self._clean_checks,
            "dirty_checks": self._dirty_checks,
            "unres_lo": self._unres_lo,
            "unres_hi": self._unres_hi,
            "fold_stepped": self._fold_stepped,
            "flushed": self._flushed,
            "eos_replicas": self._eos_replicas,
            "payload_zero": (host_copy(self._payload_zero)
                             if self._payload_zero is not None else None),
            "compactor": (self._compactor.snapshot()
                          if self._compactor is not None else None),
        }

    def restore_state(self, blob):
        """The inverse, on the graph's device: sets the capacity, the
        ring size, the TB flush payload and the step, so the first batch
        after a restore neither re-sizes the ring nor rebuilds state."""
        from windflow_tpu_torch.utils.tree import place_tree
        dev = self._state_device()
        self.NP = blob["NP"]
        self._auto_np = blob["auto_np"]
        self._np_ceil = blob["np_ceil"]
        self._overflow_steps = blob["overflow_steps"]
        self._evicted_seen = blob["evicted_seen"]
        self._evicted_base = blob["evicted_base"]
        self._error_armed = blob["error_armed"]
        self._clean_checks = blob["clean_checks"]
        self._dirty_checks = blob["dirty_checks"]
        self._unres_lo = blob["unres_lo"]
        self._unres_hi = blob["unres_hi"]
        self._fold_stepped = blob["fold_stepped"]
        self._flushed = blob["flushed"]
        self._eos_replicas = blob["eos_replicas"]
        self._pending_evct = None   # late device read: re-primed on step
        if self.mesh is not None:
            # the blob was re-bucketed for this mesh's shape by the
            # durability plane (durability/rebucket.py)
            from windflow_tpu_torch.parallel import mesh as M
            scalars = M.TB_SCALARS if self.is_tb else ()
            self._states = {int(k): M.shard_state(st, self.mesh, scalars)
                            for k, st in blob["states"].items()}
        else:
            self._states = {int(k): place_tree(st, dev)
                            for k, st in blob["states"].items()}
        self._payload_zero = (place_tree(blob["payload_zero"], dev)
                              if blob["payload_zero"] is not None
                              else None)
        if blob.get("compactor") is not None \
                and self._compactor is not None:
            self._compactor.restore(blob["compactor"])
        self._capacity = blob["capacity"]
        self._step_fn = self._build_step(self._capacity)

    # -- overflow policy and counters ------------------------------------------
    def _check_overflow(self) -> None:
        if self._auto_np and self.NP < self._np_ceil:
            return   # still growing: regrow, don't error, on overflow
        ev = self._tb_counter("n_evicted")
        if self._auto_np and not self._error_armed:
            # the undersized phase leaves a firing backlog whose drain
            # still evicts briefly after growth: arm the error after two
            # consecutive clean checkpoints, and stop excusing after four
            # dirty ones (persistent overflow at the ceiling is the
            # stream breaking the ring contract)
            if ev > self._evicted_base:
                self._dirty_checks += 1
                if self._dirty_checks <= 4:
                    self._evicted_base = ev
                    self._clean_checks = 0
                    return
                self._error_armed = True
            else:
                self._clean_checks += 1
                if self._clean_checks < 2:
                    return
                self._error_armed = True
        if ev > self._evicted_base:
            raise WindFlowError(
                f"{self.name}: TB pane ring overflow (pane_capacity="
                f"{self.NP} < window span + batch time spread + lateness "
                "panes); increase withPaneCapacity or choose overflow "
                "policy 'drop'/'count'")

    def _tb_counter(self, name: str) -> int:
        """One TB counter summed over the states: a host read, never on
        the step path."""
        return int(self._state_sum(name))

    def num_dropped_tuples(self) -> int:
        if self.is_tb and self._states:
            return self._tb_counter("n_late")
        return 0

    def dump_stats(self) -> dict:
        st = super().dump_stats()
        if self._compactor is not None:
            st["Key_compaction"] = self._compactor.summary()
        if self.is_tb and self._states:
            st["Late_tuples_dropped"] = self._tb_counter("n_late")
            st["Pane_cells_evicted"] = self._tb_counter("n_evicted")
            st["Windows_dropped_on_overflow"] = \
                self._tb_counter("n_win_dropped")
        return st
