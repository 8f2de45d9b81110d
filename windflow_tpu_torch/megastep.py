"""Megastep plane: K staged batches of one edge as ONE group (the port of
``windflow_tpu/megastep.py``).

Every staged batch pays one Python-driven round of the host loop (pack,
copy, the step's launches, emit), and on the card the steps are
launch-bound: hundreds of kernel launches for well under a millisecond
of device work (PERF.md §5).  On an eligible staging edge this plane
queues K finalized packed batches and runs them as one group: one
host→device copy of a ``[K, nwords]`` super-buffer, then the K-step body
— the shared unpack (``batch.unpack_body``, wire decode included)
feeding the tail operator's own step, K times, the carry threaded
through — then one drain that re-stamps each logical batch.  The body
has two implementations of one contract:

* on the CPU, an eager loop over the K rows (the plain version);
* on CUDA, the same K-step body captured once with ``torch.cuda.graph``
  and replayed once a group: one ``cudaGraphLaunch`` a megastep.  Static
  buffers: the ``[K, nwords]`` int32 input, the ``[K]`` int64 ``wm_pane``
  of a time-window tail (a host int in the per-batch step, which a graph
  would bake in), and the carry (the tail's state), whose final value
  the graph's last nodes copy back into it (a stateful tail's carry is
  its operator's table, which the wavefront updates in place).  The
  graph's ``[K, ...]`` outputs are overwritten by the next replay, so
  the drain clones them once a group: nothing emitted downstream is a
  view of graph memory.

Correctness stance — the per-batch path IS the reference: the body calls
the tail's own step, so a group's K outputs are record for record what K
per-batch steps produce.  Warm-up (a cold tail), a signature change, a
partial group at an external flush (EOS, punctuation) and a non-empty
tail inbox ship per batch through the emitter's own path; they are
counted (``warmup_batches``, ``fallback_batches``).  A step rebuild (TB
ring regrow) or a new wire format keys a new graph: recapture.  A capture
that fails on an eligible edge raises; there is no silent fallback.

Eligible edges: a single-destination host→device staging edge
(``DeviceStageEmitter``, exact type) on a source replica, feeding the one
replica, on one channel, of a non-compacted ``FfatWindowsGPU`` (CB or
TB), a ``ReduceGPU`` (sorted, or dense declared monoid) or a dense-keys
stateful map/filter (the associative body, or the wavefront, whose
device loop, ``kernels/loop_cuda.py``, a capture holds as a WHILE node,
as the JAX package's scan holds its ``lax.while_loop``); fused preludes
ride inside the tail's step.  :func:`tail_kind` names every refusal;
under ``Config(cuda_kernels="0")`` on the card the wavefront is one (its
plain version reads its per-rank lane counts on the host every step).

Observability: a group counts K dispatches on the tail's step-registry
handle (one a row) and each capture as a compile, a recapture as a
recompile (``monitoring/jit_registry.py``).  Traced batches of a group
are stamped on the host at the group's launch, as in the JAX package:
``collected`` and ``dispatched`` when the replay is enqueued, and, when
the sampled wait falls in the group, ``device_done`` after a CUDA event
recorded behind the replay has been waited on; each stamp carries
``shared_k = K``.  Nothing of the recorder enters the capture: the
captured body is the same with the recorder on or off.  A group's host
spans (``wf:megastep.stack``: the super-buffer; ``wf:megastep.launch``:
the stamps, copy-in, copy, replay and clones; ``wf:megastep.emit``: the
drain and the cadence hooks) wrap host code around the replay, and none
enters the capture either.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from windflow_tpu_torch import staging
from windflow_tpu_torch.basic import WindFlowError, current_time_usecs
from windflow_tpu_torch.batch import WM_NONE, DeviceBatch, unpack_body
from windflow_tpu_torch.monitoring import recorder as flightrec
from windflow_tpu_torch.utils.tree import (tree_flatten, tree_map,
                                           tree_unflatten)

#: K under "auto" on CUDA; the CPU stays per batch
AUTO_K = 8


def resolve_megastep(config) -> int:
    """The resolved group width K from ``Config.megastep_sweeps``: "auto"
    is :data:`AUTO_K` on CUDA and 1 on the CPU; an integer forces K
    anywhere (the CPU tests' lever); K <= 1 is the kill switch."""
    raw = getattr(config, "megastep_sweeps", "auto")
    if raw is None:
        raw = "auto"
    if isinstance(raw, str):
        s = raw.strip().lower()
        if s in ("", "auto"):
            import torch
            dev = torch.device(getattr(config, "device", "cuda"))
            return AUTO_K if dev.type == "cuda" else 1
        raw = int(s)
    return max(1, int(raw))


def megastep_forced(config) -> int:
    """The K the user forced (> 1), or 0 under "auto" or the kill
    switch."""
    raw = getattr(config, "megastep_sweeps", "auto")
    if raw is None:
        return 0
    if isinstance(raw, str):
        s = raw.strip().lower()
        if s in ("", "auto"):
            return 0
        raw = int(s)
    k = int(raw)
    return k if k > 1 else 0


def tail_kind(op):
    """``(kind, None)`` when ``op`` can tail a megastep, else ``(None,
    reason)``.  The kind selects the row adapter (carry and step
    signature)."""
    if not getattr(op, "is_gpu", False):
        return None, "host operator (no device step to fold into a group)"
    if getattr(op, "mesh", None) is not None:
        return None, "mesh-sharded state (per-chip collectives per batch)"
    if getattr(op, "_compactor", None) is not None:
        return None, ("compacted key space (host admission runs per "
                      "batch)")
    if getattr(op, "_fusion_exec", None) is not None:
        return None, ("all-stateless fused segment (no stateful tail "
                      "step to carry)")
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    if isinstance(op, FfatWindowsGPU):
        if op.parallelism != 1:
            return None, "parallel window state (per-replica rings)"
        return ("ffat_tb" if op.is_tb else "ffat_cb"), None
    if isinstance(op, ReduceGPU):
        if op.monoid is not None and op.max_keys is not None:
            return "reduce_dense", None
        return "reduce_sorted", None
    if isinstance(op, _StatefulGPUBase):
        if not op.dense_keys:
            return None, ("host-interning stateful (per-batch key read; "
                          "declare withDenseKeys)")
        dev = op.device if op.device is not None \
            else getattr(op.config, "device", "cuda")
        if op.assoc is None and str(dev).startswith("cuda"):
            from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
            if not resolve_kernels(op.config):
                return None, ("stateful wavefront with the CUDA kernels "
                              "off (Config.cuda_kernels='0': its plain "
                              "version reads the per-rank lane counts on "
                              "the host every step)")
        return "stateful", None
    return None, f"unsupported tail operator {type(op).__name__}"


class _SpanMeta:
    """Host-metadata stand-in for a DeviceBatch: the fields
    ``FfatWindowsGPU._regrow_for_span`` reads (host stamps, no device
    read)."""

    __slots__ = ("ts_max", "ts_min", "frontier")

    def __init__(self, ts_max, ts_min, frontier):
        self.ts_max = ts_max
        self.ts_min = ts_min
        self.frontier = frontier


def _row(kind: str):
    """The per-row adapter: ``(step, carry, payload, ts, valid, wm) ->
    (carry, (out, out_ts, out_valid))`` around the tail's own step."""
    if kind == "ffat_cb":
        def row(step, carry, payload, ts, valid, wm):
            st, out, fired, out_ts = step(carry, payload, ts, valid)
            return st, (out, out_ts, fired)
    elif kind == "ffat_tb":
        def row(step, carry, payload, ts, valid, wm):
            st, out, fired, out_ts, _n_adv = step(carry, payload, ts,
                                                  valid, wm)
            return st, (out, out_ts, fired)
    elif kind == "reduce_sorted":
        def row(step, carry, payload, ts, valid, wm):
            _keys, out, out_ts, out_valid = step(None, payload, ts, valid)
            return carry, (out, out_ts, out_valid)
    elif kind == "reduce_dense":
        def row(step, carry, payload, ts, valid, wm):
            table, ts_t, has, n_drop = step(None, payload, ts, valid)
            return carry + n_drop, (table, ts_t, has)
    else:   # stateful dense keys: the wavefront or the associative body
        def row(step, carry, payload, ts, valid, wm):
            st, out, out_valid = step(carry, payload, valid, None)
            return st, (out, ts, out_valid)
    return row


class _Group:
    """One cached group body for one (step, wire format, lanes, K)
    signature: the eager loop on the CPU; on CUDA the captured graph with
    its static input, ``wm`` and carry buffers and its ``[K, ...]``
    outputs."""

    def __init__(self, body, graph=None, x=None, wm=None, carry=None,
                 ys=None):
        self.body = body
        self.graph = graph          # kernels.ffat_cuda.CountedGraph
        self.x = x
        self.wm = wm
        self.carry = carry
        self.ys = ys


class MegastepEdge:
    """One eligible staging edge: the packet queue, the cached group body
    (captured graph on the card) and the drain that replays the
    per-batch bookkeeping.

    The feeding ``DeviceStageEmitter`` offers every finalized packed
    batch (``offer``); acceptance queues it and the K-th packet runs the
    group.  Refusal (a cold tail) and ``drain_remainder`` (an external
    flush) ship per batch through the emitter's own path."""

    def __init__(self, k: int, op, rep, emitter, kind: str) -> None:
        self.k = k
        self.op = op
        self.rep = rep          # the tail operator's single replica
        self.emitter = emitter  # the feeding DeviceStageEmitter
        self.kind = kind
        self._row = _row(kind)
        self._q = []
        # group cache: the step object it was built on (held strongly:
        # identity is the rebuild signal) and the signature
        self._group = None
        self._group_step = None
        self._group_sig = None
        self.megasteps = 0
        self.batches = 0            # logical batches served by groups
        self.fallback_batches = 0   # per-batch ships while warm
        self.warmup_batches = 0     # per-batch ships while cold
        #: group bodies built: graph captures on the card, eager body
        #: rebuilds on the CPU (the same cache decision)
        self.captures = 0
        self._span_sum_usec = 0.0
        self._span_n = 0
        self._wm_np = np.empty(k, np.int64)

    # -- eligibility at offer time -------------------------------------------
    def _tail_warm(self, cap: int) -> bool:
        """True once the tail's per-batch path built what the body reuses
        (capacity pinned, step built, state initialized, first-batch
        checks done): until then the per-batch path is the warm-up."""
        op, kind = self.op, self.kind
        if op._compactor is not None:
            return False    # attached after the plane: stand down
        if kind in ("ffat_cb", "ffat_tb"):
            if op._capacity != cap or op._step_fn is None \
                    or 0 not in op._states:
                return False
            return not (kind == "ffat_tb" and op._payload_zero is None)
        if kind == "reduce_dense":
            return ("dense", cap) in op._steps
        return cap in op._steps     # reduce_sorted, stateful

    def _step(self, cap: int):
        op, kind = self.op, self.kind
        if kind in ("ffat_cb", "ffat_tb"):
            return op._step_fn
        if kind == "reduce_dense":
            return op._steps.get(("dense", cap))
        return op._steps.get(cap)

    @staticmethod
    def _sig(pkt):
        return (pkt.treedef, pkt.dtypes, pkt.capacity, pkt.fmt,
                pkt.buf.shape[0])

    # -- emitter contract ----------------------------------------------------
    def offer(self, pkt) -> bool:
        """Queue one finalized packed batch.  False: the caller ships it
        per batch (cold tail).  A signature change against the queued
        group drains the group per batch first: a group only ever runs K
        same-shaped buffers."""
        if not self._tail_warm(pkt.capacity):
            self.warmup_batches += 1
            return False
        if self._q and self._sig(self._q[0]) != self._sig(pkt):
            self.drain_remainder()
        if self.kind == "ffat_tb":
            # the per-batch step's host preamble, replayed in arrival
            # order: span regrow (which may rebuild the step: the group
            # cache then rebuilds), the fold flag, the packet's wm_pane
            op = self.op
            front = pkt.frontier if pkt.frontier >= pkt.wm else pkt.wm
            if op._auto_np:
                op._regrow_for_span(_SpanMeta(pkt.ts_max, pkt.ts_min,
                                              front))
            if front != WM_NONE:
                op._fold_stepped = True
            pkt.wm_pane = op._wm_pane(front)
        self._q.append(pkt)
        if len(self._q) >= self.k:
            self.run()
        return True

    def drain_remainder(self) -> None:
        """Ship every queued packet per batch, in order: an external flush
        (EOS, punctuation) never lets a watermark overtake queued data."""
        q, self._q = self._q, []
        for pkt in q:
            self.fallback_batches += 1
            self.emitter._ship_packed(pkt)

    # -- the group body ------------------------------------------------------
    def _body(self, step, pkt):
        """``(carry, x [K, nwords] int32, wm [K] int64 | None) -> (carry,
        ys)``: K rows of the shared unpack + the tail's step, the rows'
        outputs stacked leafwise on a leading K axis."""
        import torch
        k, row = self.k, self._row
        treedef = pkt.treedef
        unpack = unpack_body(pkt.dtypes, pkt.capacity, wire=pkt.fmt)

        def body(carry, x, wm):
            outs = []
            for i in range(k):
                cols, ts, valid = unpack(x[i])
                carry, y = row(step, carry, tree_unflatten(treedef, cols),
                               ts, valid, None if wm is None else wm[i])
                outs.append(y)
            ys = tree_map(lambda *a: torch.stack(a), *outs)
            return carry, ys
        return body

    def _group_for(self, step, pkt, carry):
        sig = self._sig(pkt)
        if self._group is not None and self._group_step is step \
                and self._group_sig == sig:
            return self._group
        body = self._body(step, pkt)
        if self.op.device.type == "cuda":
            t0 = time.perf_counter()
            group = self._capture(body, pkt, carry)
            self.op.watch.note_capture((time.perf_counter() - t0) * 1e3)
        else:
            group = _Group(body)
        self._group, self._group_step, self._group_sig = group, step, sig
        self.captures += 1
        return group

    def _capture(self, body, pkt, carry) -> _Group:
        """Capture the K-step body as one CUDA graph.  The static carry
        starts as a copy of the live state; a warm-up run on a side
        stream (scratch carry, an all-invalid input; its kernel launches
        serve no batch and are not counted) comes first, as capture
        wants.  A failure raises: an eligible edge never falls back
        silently."""
        import torch

        from contextlib import nullcontext

        from windflow_tpu_torch.analysis import ir_audit
        from windflow_tpu_torch.kernels.ffat_cuda import (CountedGraph,
                                                          uncounted)
        dev = self.op.device
        old = self._group
        if old is not None and old.graph is not None:
            old.graph.graph.reset()     # its private pool goes with it
        self._group = None
        x = torch.zeros((self.k, pkt.buf.shape[0]), dtype=torch.int32,
                        device=dev)
        wm = torch.zeros(self.k, dtype=torch.int64, device=dev) \
            if self.kind == "ffat_tb" else None
        # a stateful tail's carry is the operator's table itself: the
        # wavefront updates it in place (nothing the size of the key
        # space is copied in or out), and the warm-up's all-invalid rows
        # leave its rows as they are; other carries start as a copy
        shared = self.kind == "stateful"
        static = carry if shared or carry is None \
            else tree_map(torch.clone, carry)
        try:
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), uncounted():
                body(static if shared or static is None
                     else tree_map(torch.clone, static), x, wm)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = CountedGraph(torch.cuda.CUDAGraph())
            # the capture audit records this capture's body (the one
            # capture: no extra one), None when off or recorded already
            audit = ir_audit.capture_audit(
                self.op, f"{self.op.name} [megastep {self.kind} "
                f"K={self.k}]", repr(self._sig(pkt)), self.op.config)
            with graph.capture(torch.cuda.graph(graph.graph)):
                with audit if audit is not None else nullcontext():
                    new_carry, ys = body(static, x, wm)
                    if static is not None:
                        for s, n in zip(tree_flatten(static)[0],
                                        tree_flatten(new_carry)[0]):
                            if s is not n:
                                s.copy_(n)
            if audit is not None:
                audit.finish(graph.launches)
        except Exception as e:  # lint: broad-except-ok (re-raised
            # with the cause)
            raise WindFlowError(
                f"megastep: capturing the {self.kind} step of "
                f"'{self.op.name}' (K = {self.k}) as a CUDA graph failed: "
                f"{type(e).__name__}: {e}") from e
        return _Group(body, graph, x, wm, static, ys)

    # -- carry ---------------------------------------------------------------
    def _carry_init(self):
        import torch
        op, kind = self.op, self.kind
        if kind in ("ffat_cb", "ffat_tb"):
            return op._states[0]
        if kind == "stateful":
            return op._state
        if kind == "reduce_dense":
            d = op._dropped
            return torch.zeros((), dtype=torch.int64, device=op.device) \
                if d is None else d
        return None

    def _commit_carry(self, carry) -> None:
        op, kind = self.op, self.kind
        if kind in ("ffat_cb", "ffat_tb"):
            op._states[0] = carry
        elif kind == "stateful":
            op._state = carry
        elif kind == "reduce_dense":
            op._dropped = carry

    # -- the megastep itself -------------------------------------------------
    def run(self) -> None:
        """One full group: stack the queued buffers into a pooled
        super-buffer, one copy to the device, the group body (one graph
        replay on the card), the carry committed, then the drain emitting
        K per-batch DeviceBatches with their own stamps."""
        import torch
        if len(self._q) < self.k:
            return
        rep = self.rep
        if rep.inbox or rep.done:
            # warm-up stragglers (or punctuation) still queued at the
            # tail: the group would overtake them — per batch, in order
            self.drain_remainder()
            return
        step = self._step(self._q[0].capacity)
        if step is None:
            self.drain_remainder()
            return
        group, self._q = self._q, []
        carry = self._carry_init()
        g = self._group_for(step, group[0], carry)
        with flightrec.span("wf:megastep.stack"):
            nwords = group[0].buf.shape[0]
            pool = group[0].pool
            sup = pool.acquire(self.k * nwords)
            for i, p in enumerate(group):
                sup[i * nwords:(i + 1) * nwords] = p.buf
                p.pool.release(p.buf, None)     # host copy done: no gate
            host = torch.from_numpy(
                sup.view(np.int32).reshape(self.k, nwords))
            if self.kind == "ffat_tb":
                for i, p in enumerate(group):
                    self._wm_np[i] = p.wm_pane
        with flightrec.span("wf:megastep.launch"):
            # the trace lane at group times: collected and dispatched as the
            # group launches (emitted→dispatched is each batch's real wait
            # for its group), each stamp shared by the K batches
            ring = rep.ring
            traced = [p.trace for p in group if p.trace is not None] \
                if ring is not None else ()
            if traced:
                t_disp = current_time_usecs()
                for tr in traced:
                    ring.record(tr[0], flightrec.COLLECTED, t_disp,
                                shared=self.k)
                    ring.record(tr[0], flightrec.DISPATCHED, t_disp,
                                shared=self.k)
            if g.graph is None:
                carry, ys = g.body(carry, host.clone(),
                                   torch.from_numpy(self._wm_np.copy())
                                   if self.kind == "ffat_tb" else None)
                pool.release(sup, None)
            else:
                dev = self.op.device
                stream = torch.cuda.current_stream(dev)
                if carry is not None:
                    # the live state is not the graph's carry after warm-up
                    # or a per-batch ship: copy it in
                    for s, c in zip(tree_flatten(g.carry)[0],
                                    tree_flatten(carry)[0]):
                        if s is not c:
                            s.copy_(c)
                g.x.copy_(host, non_blocking=True)
                gate = torch.cuda.Event()
                gate.record(stream)
                if g.wm is not None:
                    wm_host = torch.empty(self.k, dtype=torch.int64,
                                          pin_memory=True)
                    wm_host.numpy()[:] = self._wm_np
                    g.wm.copy_(wm_host, non_blocking=True)
                g.graph.replay()
                pool.release(sup, gate)
                carry = g.carry
                # the graph's outputs are rewritten by the next replay: one
                # clone a leaf, so nothing downstream views graph memory
                ys = tree_map(torch.clone, g.ys)
            if traced and self._stamp_device_done(traced, ys) \
                    and rep.latency is not None:
                self._note_freshness(group, ys)
        with flightrec.span("wf:megastep.emit"):
            self._commit_carry(carry)
            self.megasteps += 1
            self.batches += self.k
            for p in group:
                if p.ts_max is not None and p.ts_min is not None \
                        and p.ts_max >= p.ts_min > 0:
                    self._span_sum_usec += p.ts_max - p.ts_min
                    self._span_n += 1
            self._emit(group, ys)
            self._post_hooks()

    def _stamp_device_done(self, traced, ys) -> bool:
        """``device_done`` for the group's traced batches when the
        sampled wait falls among them: one wait on an event behind the
        group's work, one stamp shared by the K batches.  Returns whether
        it waited."""
        rep = self.rep
        every = rep.config.trace_device_sync_every
        if not every:
            return False
        before = rep._traced_seen
        rep._traced_seen += len(traced)
        if rep._traced_seen // every == before // every:
            return False
        from windflow_tpu_torch.ops.gpu import wait_for_device
        wait_for_device(ys[2])
        t_done = current_time_usecs()
        for tr in traced:
            rep.ring.record(tr[0], flightrec.DEVICE_DONE, t_done,
                            shared=self.k)
        return True

    def _note_freshness(self, group, ys) -> None:
        """The latency ledger's window-freshness gauge for the traced
        batches of a group the recorder waited on: on the card the read
        copies the fired lanes back, which waits for nothing only then."""
        if self.kind not in ("ffat_cb", "ffat_tb"):
            return
        lat = self.rep.latency
        for i, p in enumerate(group):
            if p.trace is not None:
                lat.note_window_fire(self.op.name, ys[1][i], ys[2][i])

    def _emit(self, group, ys) -> None:
        """Each logical batch advances the tail replica's watermark and
        counters exactly as its own step would (one dispatch a row in the
        step registry), then rides the tail's emitter downstream with its
        own trace lane."""
        rep, op, kind = self.rep, self.op, self.kind
        fused = op._fused_prelude is not None
        filt = bool(getattr(op, "_is_filter", False))
        outs, out_ts, out_valid = ys
        for i, p in enumerate(group):
            rep._advance_wm(p.wm)
            rep.stats.inputs_received += p.n
            pay = tree_map(lambda a: a[i], outs)
            front = p.frontier if p.frontier >= p.wm else p.wm
            if kind in ("ffat_cb", "ffat_tb"):
                out = DeviceBatch(pay, out_ts[i], out_valid[i],
                                  watermark=p.wm, size=None)
            elif kind in ("reduce_sorted", "reduce_dense"):
                out = DeviceBatch(pay, out_ts[i], out_valid[i],
                                  watermark=p.wm, size=None, frontier=front)
            else:
                size = None if (filt or fused) else p.n
                out = DeviceBatch(pay, out_ts[i], out_valid[i],
                                  watermark=p.wm, size=size, frontier=front,
                                  ts_max=p.ts_max, ts_min=p.ts_min)
            out.trace = p.trace
            staging.device_bytes.note(p.buf.nbytes, p.logical_nbytes)
            op.watch.note()
            rep.stats.device_programs_launched += 1
            rep.stats.outputs_sent += out.known_size or 0
            rep.emitter.emit_device_batch(out)
            rep._maybe_hook_wm()

    def _post_hooks(self) -> None:
        """The per-batch cadence checkpoints, once a group (they may read
        the device, outside the graph)."""
        op, kind = self.op, self.kind
        if kind == "ffat_tb":
            from windflow_tpu_torch.windows.ffat_gpu import CHECK_EVERY
            before = op._overflow_steps
            op._overflow_steps = before + self.k
            if (before + self.k) // CHECK_EVERY > before // CHECK_EVERY:
                if op._auto_np:
                    op._maybe_regrow()
                if op.overflow_policy == "error":
                    op._check_overflow()
        elif kind == "reduce_dense":
            op._drop_steps += self.k
            if not op._drop_warned and op._drop_steps % 64 < self.k:
                prev = op._pending_drop
                # a snapshot: the carry is rewritten by the next replay
                op._pending_drop = op._dropped.clone()
                if prev is not None:
                    op._maybe_warn_drops(int(prev))

    def freshness_floor_usec(self):
        """The freshness floor a group imposes: a batch's result cannot
        leave the device sooner than K x the mean batch event-time span
        it waited to group with; None before any grouped batch carried
        event-time extrema."""
        if not self._span_n:
            return None
        return round(self.k * self._span_sum_usec / self._span_n, 3)

    def summary(self) -> dict:
        g = self._group
        return {
            "operator": self.op.name,
            "kind": self.kind,
            "k": self.k,
            "megasteps": self.megasteps,
            "batches": self.batches,
            "fallback_batches": self.fallback_batches,
            "warmup_batches": self.warmup_batches,
            "freshness_floor_usec": self.freshness_floor_usec(),
            "captures": self.captures,
            # kernel-wrapper launches one replay makes (0 on the CPU)
            "kernel_launches_per_group":
                g.graph.launches_per_replay()
                if g is not None and g.graph is not None else 0,
        }


class MegastepPlane:
    """Graph-level view: the resolved K, the eligible edges, and the
    edges whose tail refused (with :func:`tail_kind`'s reason).
    ``active`` gates the scheduler's K-granular source ticking."""

    def __init__(self, k: int) -> None:
        self.k = k
        self.edges = []
        self.refused = []

    @property
    def active(self) -> bool:
        return self.k > 1 and bool(self.edges)

    def summary(self) -> dict:
        return {"k": self.k,
                "edges": [e.summary() for e in self.edges],
                "refused": list(self.refused)}


def attach_plane(config, source_replicas) -> MegastepPlane:
    """Hook a :class:`MegastepEdge` onto every eligible staging emitter of
    the built graph's source replicas.  Anything the edge cannot prove
    safe stays on the per-batch path."""
    plane = MegastepPlane(resolve_megastep(config))
    if plane.k <= 1:
        return plane
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    for rep in source_replicas:
        em = rep.emitter
        # exact type: the keyed staging emitter partitions per batch
        if type(em) is not DeviceStageEmitter \
                or em._megastep is not None or len(em.dests) != 1:
            continue
        tail, _ch = em.dests[0]
        top = tail.op
        # exactly ONE feeding channel: a merged tail folds watermarks
        # across channels in arrival order, which the drain cannot
        if tail.num_channels != 1 or top.parallelism != 1:
            continue
        kind, why = tail_kind(top)
        if kind is None:
            plane.refused.append({"operator": top.name, "reason": why})
            continue
        if tail.emitter is None \
                or not hasattr(tail.emitter, "emit_device_batch"):
            continue
        edge = MegastepEdge(plane.k, top, tail, em, kind)
        em._megastep = edge
        plane.edges.append(edge)
    return plane


def round_epoch_to_megastep(config, plane: MegastepPlane) -> Optional[int]:
    """Align a durability epoch cadence to megastep boundaries:
    ``Config.durability_epoch_sweeps`` counts logical sweeps, and
    under an active plane one scheduler sweep paces K of them, so the
    value becomes ``ceil(eps / K)`` scheduler sweeps.  Returns the new
    cadence when it changed, else None; idempotent at a fixed K."""
    if not plane.active:
        return None
    eps = config.durability_epoch_sweeps
    if eps <= 0:
        return None
    sweeps = max(1, (eps + plane.k - 1) // plane.k)
    if sweeps == eps:
        return None
    config.durability_epoch_sweeps = sweeps
    return sweeps
