"""Keyed stateful device operators: per-key state on the card (the
single-card port of ``windflow_tpu/ops/tpu_stateful.py``; reference
stateful ``Map_GPU`` / ``Filter_GPU``, ``map_gpu.hpp:78-102``,
``filter_gpu.hpp:119``).

The state is a dense pytree of ``[num_key_slots, ...]`` tensors on the
OPERATOR, shared by its replicas (the keyed edges send each key to one
replica, and the host scheduler steps replicas one at a time: the role
of the reference's spinlock).  Each leaf is the first ``num_key_slots``
rows of a table allocated once with one row more, the wavefront's dump
row (:func:`_state_table`): the wavefront updates the operator's table
in place, so a step's work follows the batch, never the key space.  A
key reaches its slot by one of three routes, picked per operator as in
the JAX package:

* **dense keys** (``withDenseKeys``): the extractor returns the slot;
  out-of-range keys are masked invalid;
* **compacted** (a host-fed operator under ``Config.key_compaction``,
  ``parallel/compaction.py``): a pinned ``KeyCompactor`` admits every
  key on the host before its batch ships and the step looks the slots
  up in its tables, so the per-batch intern read goes away;
* **interned**: the batch's keys and mask come to the host, a
  :class:`~windflow_tpu_torch.parallel.emitters.KeyInterner` gives each
  distinct key a slot, and the sorted key/slot tables go back in one
  copy.

Two bodies apply the user function in each key's arrival order:

* :func:`_wavefront_body` (``fn(record, state) -> (record, state)``, or
  ``(keep, state)`` for a filter): lanes sorted by slot, each lane's
  rank among its key's lanes (its sorted position less the start of its
  key's run, a scan over the batch), and one application a rank — lanes
  of one rank hold distinct keys, so their state rows gather and scatter
  without conflict.  The live lanes are ordered by (rank, slot) and the
  lanes of each rank counted; with the kernels on, the card runs the
  ranks as a device loop (:class:`_ClassLoop`, a CUDA graph WHILE node,
  the counterpart of the JAX package's ``lax.while_loop``: no host
  read, so a megastep folds it), each pass a power-of-two window of the
  rank's slice.  The plain version reads the per-rank lane counts on the
  host (one read, a second only when one key holds more than
  ``RANK_READ`` lanes of a batch) and runs ``fn`` on each rank's slice.
  Either is O(capacity) work where a masked full-width loop would be
  O(depth x capacity); the depth is the hottest key's lane count, so a
  skewed stream wants (each step adds its batch, passes and live lanes
  to the body's device counter, ``stats()["Stateful"]``):
* :func:`_assoc_body` (``withAssociativeUpdate(lift, comb, project)``):
  ``state' = comb(state, lift(record))`` folded per key by a segmented
  inclusive scan with ``lax.associative_scan``'s combine tree, then
  ``project(record, state including the record)``.  No host read, and a
  hot key costs what a uniform stream costs.

``snapshot_state``/``restore_state`` carry the slot table, the interner
and the remap across a checkpoint in the JAX package's blob layout.

On a mesh (``Config.mesh``) the table is key-sharded (slot ranges per
key shard) and the step is ``parallel/mesh.make_sharded_stateful_step``
over the same bodies built for the shard's slot count: dense keys with
no host read (but the plain wavefront's), interned keys through the
interning route's tables (compaction does not attach on a mesh).  A
checkpoint holds the assembled table; a restore re-shards it for the
restoring mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.gpu import _GPUReplica
from windflow_tpu_torch.parallel.emitters import KeyInterner
from windflow_tpu_torch.utils.dtypes import cast_state_update as _cast_update
from windflow_tpu_torch.utils.tree import (per_record, per_record2,
                                           tree_flatten, tree_map,
                                           tree_unflatten)
from windflow_tpu_torch.windows.ffat_kernels import _b, associative_scan
from windflow_tpu_torch.windows.grouping import auto_order, invert_perm

#: pads the interning route's sorted key table
KEY_SENTINEL = 2**31 - 1
#: per-rank lane counts taken by the wavefront's first (usually only)
#: host read
RANK_READ = 1024


def _as_tensor(x) -> torch.Tensor:
    """A state prototype leaf as a tensor, with numpy's dtype rules for
    Python and numpy scalars (``0.0`` float64, ``0`` int64), which are the
    JAX package's under its process-wide x64."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def _broadcast_state(proto, num_slots: int, device=None):
    """The ``[S, ...]`` state table from one per-key prototype."""
    def rep(x):
        a = _as_tensor(x).to(device)
        return a.unsqueeze(0).repeat((num_slots,) + (1,) * a.ndim)
    return tree_map(rep, proto)


def _rows(tables, num_slots: int):
    """The first ``num_slots`` rows of every leaf (views)."""
    return tree_map(lambda a: a[:num_slots], tables)


def _state_table(proto, num_slots: int, device=None):
    """An operator's state: the ``[num_slots, ...]`` views of tables
    allocated once with the dump row ``num_slots`` after them."""
    return _rows(_broadcast_state(proto, num_slots + 1, device), num_slots)


def _extended(state):
    """``state`` (plain ``[S, ...]`` tables) copied into ``[S + 1, ...]``
    tables, the last row a dump row."""
    return tree_map(lambda a: torch.cat([a, a[:1]]), state)


def _dump_tables(state, num_slots: int):
    """The ``[num_slots + 1, ...]`` tables whose first rows the leaves of
    ``state`` are (an operator's table, :func:`_state_table`), or None for
    tables without the dump row (a mesh shard's, a caller's)."""
    leaves, treedef = tree_flatten(state)
    out = []
    for a in leaves:
        b = a._base
        if b is None:
            return None
        head = (b.shape[0], b.shape[1:], b.dtype, b.data_ptr())
        # wfverify: ok (shapes, dtypes and addresses: host values)
        if head != (num_slots + 1, a.shape[1:], a.dtype, a.data_ptr()) \
                or not b.is_contiguous():
            return None
        out.append(b)
    return tree_unflatten(treedef, out)


def _place_state(state, device, num_slots: int):
    """``state`` on ``device``, its dump row moved with it."""
    def move(tree):
        return tree_map(lambda a: a.to(device, non_blocking=True), tree)
    full = _dump_tables(state, num_slots)
    return move(state) if full is None else _rows(move(full), num_slots)


def _slot_key(valid, slots, S: int):
    """The grouping id of every lane: its slot, or ``S`` (the trailing
    bucket) for invalid and out-of-range lanes."""
    return torch.where(valid & (slots < S), slots.to(torch.int32), S)


def _sort_by_slot(valid, slots, S: int):
    """The stable grouping of lanes by slot: ``(order, sorted slots)``."""
    sort_key = _slot_key(valid, slots, S)
    order = auto_order(sort_key, S + 1).long()
    return order, sort_key[order]


def _seg_starts(s_slots):
    starts = torch.ones_like(s_slots, dtype=torch.bool)
    starts[1:] = s_slots[1:] != s_slots[:-1]
    return starts


def _update_rows(state, new, idx, what: str) -> None:
    """Write the ``[n]`` rows ``new`` into ``state`` at the distinct slots
    ``idx``, in place, cast under the state dtype policy."""
    st_leaves, st_def = tree_flatten(state)
    nw_leaves, nw_def = tree_flatten(new)
    if st_def != nw_def:  # wfverify: ok (tree structures, on the host)
        raise WindFlowError(
            f"{what} returned a state of another structure than the "
            f"initial state ({nw_def} vs {st_def})")
    for a, u in zip(st_leaves, nw_leaves):
        a.index_copy_(0, idx, _cast_update(u, a.dtype, what).reshape(
            (idx.shape[0],) + tuple(a.shape[1:])))


def _rank_counts(cnt: torch.Tensor) -> list:
    """The nonzero prefix of the per-rank lane counts (non-increasing in
    the rank): one host read, a second only past ``RANK_READ`` ranks."""
    # wfverify: ok (the wavefront's per-rank lane counts: one read a
    # step, by design; a second only past RANK_READ ranks)
    head = cnt[:RANK_READ].cpu().numpy()
    if head.shape[0] == RANK_READ and head[-1] > 0:
        # wfverify: ok (the second read, past RANK_READ ranks)
        head = np.concatenate([head, cnt[RANK_READ:].cpu().numpy()])
    return head[:int(np.count_nonzero(head))].tolist()


class _ClassLoop:
    """The kernel route of the wavefront: the device loop over width
    classes (``kernels/loop_cuda.py``, the counterpart of the JAX
    package's ``lax.while_loop``).

    A pass takes rank r's slice of the lanes ordered by (rank, slot):
    the class of width ``w`` (the smallest that holds the slice) gathers
    ``w`` lanes from the slice's first, clamped to the batch, applies the
    function to all of them and scatters; lanes past the slice's count go
    to the dump row ``S`` of the state and the dump lane ``capacity`` of
    the outputs.  An operator's table holds the dump row
    (:func:`_state_table`) and is updated in place; a table without it (a
    mesh shard's, a caller's) is copied once into one that has it.  On
    the card outside a capture the loop is a small cached graph over
    static buffers (the payload, the lane order, the counts and the
    outputs: eager code copies them in, replays, and clones the outputs
    out; the state buffer is the operator's table itself); inside a
    capture (a megastep) it is emitted inline.  On CPU tensors the same
    class bodies run under the plain twin of the steering kernel,
    :func:`loop_cuda.run_loop_plain`."""

    def __init__(self, fn, capacity: int, num_slots: int, is_filter: bool,
                 what: str, name: str) -> None:
        from windflow_tpu_torch.kernels import loop_cuda
        self.fn, self.capacity, self.S = fn, capacity, num_slots
        self.is_filter, self.what, self.name = is_filter, what, name
        self.widths = loop_cuda.width_classes(num_slots, capacity)
        #: per device (a mesh body serves every position): the
        #: standalone CountedGraph, its signature, its static buffers and
        #: its depth scalar
        self.cached = {}
        #: the last loop's depth: a device scalar on the card
        self.depth = None

    # -- buffers -------------------------------------------------------------
    def _tables(self, state):
        """``(tables with the dump row, whether they are the caller's)``:
        the operator's own, or a copy with the dump row added."""
        full = _dump_tables(state, self.S)
        if full is not None:
            return full, True
        return _extended(state), False

    def _new_outs(self, leaf_spec, dev):
        cap = self.capacity + 1
        if self.is_filter:
            return torch.ones(cap, dtype=torch.bool, device=dev)
        return [torch.zeros((cap,) + trail, dtype=dt, device=dev)
                for dt, trail in leaf_spec]

    def _reset_outs(self, outs) -> None:
        if self.is_filter:
            outs.fill_(True)
        else:
            for o in outs:
                o.zero_()

    def _cut_outs(self, outs, clone: bool):
        cap = self.capacity
        f = (lambda a: a.clone()) if clone else (lambda a: a)
        if self.is_filter:
            return f(outs[:cap])
        return [f(o[:cap]) for o in outs]

    # -- one class's window --------------------------------------------------
    def window(self, st, payload, w, w_slots, cur, outs, width: int):
        """Apply the function to ``width`` lanes from rank r's first
        (``cur[2]``); the first ``cur[3]`` are the rank's."""
        cap, S = self.capacity, self.S
        dev = w.device
        i = torch.arange(width, device=dev)
        pos = torch.clamp(cur[2] + i, max=cap - 1)
        ok = i < cur[3]
        lane = w[pos]
        sl = torch.where(ok, w_slots[pos], S)
        rows = tree_map(lambda a: a[sl], st)
        rec = tree_map(lambda a: a[lane], payload)
        res, new = per_record2(self.fn, rec, rows, width)
        # slots within a rank are distinct; dump lanes all write row S
        _update_rows(st, new, sl, self.what)
        dest = torch.where(ok, lane, cap)
        if self.is_filter:
            outs.index_copy_(0, dest, res.to(torch.bool).reshape(-1))
            return
        for o, r in zip(outs, tree_flatten(res)[0]):
            o.index_copy_(0, dest, r.to(o.dtype).reshape(
                (width,) + tuple(o.shape[1:])))

    # -- the loop ------------------------------------------------------------
    def run(self, state, payload, w, w_slots, cnt, leaf_spec):
        """``(new state [S], outputs [capacity])`` of one batch's loop: the
        new state is ``state`` itself, updated in place, when it is an
        operator's table."""
        from windflow_tpu_torch.kernels import loop_cuda
        dev = cnt.device
        if dev.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            return self._replay(state, payload, w, w_slots, cnt, leaf_spec)
        st, own = self._tables(state)
        outs = self._new_outs(leaf_spec, dev)
        cur = torch.zeros(loop_cuda.CUR_WORDS, dtype=torch.int64, device=dev)
        if dev.type == "cpu":
            self.depth = loop_cuda.run_loop_plain(
                cnt, cur, self.widths, lambda width: self.window(
                    st, payload, w, w_slots, cur, outs, width))
        else:
            c = self.cached.get(dev)
            if c is None:
                raise WindFlowError(
                    f"stateful operator '{self.name}': the wavefront's "
                    "device loop is captured before its first per-batch "
                    "step warmed its class bodies up")
            self._emit(c["depth"], st, payload, w, w_slots, cnt, cur, outs)
            self.depth = c["depth"]
        # wfverify: ok (own: whether the table has its dump row, a host
        # value of its shape and address)
        return (state if own else _rows(st, self.S)), \
            self._cut_outs(outs, False)

    def _emit(self, depth, st, payload, w, w_slots, cnt, cur, outs) -> None:
        from windflow_tpu_torch.kernels import loop_cuda
        depth.copy_(torch.count_nonzero(cnt))
        loop_cuda.emit_loop(cnt, cur, self.widths, lambda width: self.window(
            st, payload, w, w_slots, cur, outs, width))

    def _replay(self, state, payload, w, w_slots, cnt, leaf_spec):
        full = _dump_tables(state, self.S)
        sig = (tree_flatten(payload)[1],
               tuple((l.dtype, tuple(l.shape))
                     for l in tree_flatten(payload)[0]),
               tuple((l.dtype, tuple(l.shape))
                     for l in tree_flatten(state)[0]),
               # the graph is bound to the operator's table it updates
               None if full is None
               else tuple(l.data_ptr() for l in tree_flatten(full)[0]))
        c = self.cached.get(cnt.device)
        if c is None or c["sig"] != sig:
            c = self._build(state, full, payload, w, w_slots, cnt,
                            leaf_spec)
            c["sig"] = sig
        b = c["static"]
        for s, a in zip(tree_flatten(b["payload"])[0],
                        tree_flatten(payload)[0]):
            s.copy_(a)
        b["w"].copy_(w)
        b["w_slots"].copy_(w_slots)
        b["cnt"].copy_(cnt)
        if full is None:
            # a table without the dump row: through the graph's own copy
            for s, a in zip(tree_flatten(b["st"])[0],
                            tree_flatten(state)[0]):
                s[:self.S].copy_(a)
        c["graph"].replay()
        self.depth = c["depth"]
        new = state if full is not None \
            else tree_map(lambda a: a[:self.S].clone(), b["st"])
        return new, self._cut_outs(b["outs"], True)

    def _build(self, state, full, payload, w, w_slots, cnt,
               leaf_spec) -> dict:
        """The static buffers, one eager warm-up of every class body (a
        function that synchronises with the host raises here, naming the
        operator), and the capture of the standalone loop graph: the
        device's cache entry.  The state buffer is ``full`` (the
        operator's table), else a copy with the dump row."""
        import warnings

        from windflow_tpu_torch.kernels import ffat_cuda as fc
        from windflow_tpu_torch.kernels import loop_cuda
        dev = cnt.device
        loop_cuda.prepare(dev)
        old = self.cached.pop(dev, None)
        if old is not None:
            old["graph"].graph.reset()
        depth = torch.zeros((), dtype=torch.int64, device=dev)
        b = {"payload": tree_map(torch.clone, payload), "w": w.clone(),
             "w_slots": w_slots.clone(), "cnt": cnt.clone(),
             "st": full if full is not None else self._tables(state)[0],
             "outs": self._new_outs(leaf_spec, dev),
             "cur": torch.zeros(loop_cuda.CUR_WORDS, dtype=torch.int64,
                                device=dev)}
        args = (b["st"], b["payload"], b["w"], b["w_slots"], b["cur"],
                b["outs"])
        # warm-up: cur is all zeros, so every lane is a dump lane (the
        # table's rows [0, S) are left as they are)
        with fc.capture_lock, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for width in self.widths:
                    self.window(*args, width)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                raise WindFlowError(
                    f"stateful operator '{self.name}': its function "
                    f"synchronises with the host ({e}), so the wavefront's "
                    "device loop cannot capture it; keep the function on "
                    "the device (no .item(), .cpu(), .tolist() or `if` on "
                    "a tensor)") from e
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        graph = fc.CountedGraph(torch.cuda.CUDAGraph())
        try:
            with graph.capture(loop_cuda.side_capture(graph.graph, dev)):
                self._reset_outs(b["outs"])
                self._emit(depth, b["st"], b["payload"], b["w"],
                           b["w_slots"], b["cnt"], b["cur"], b["outs"])
        except WindFlowError:
            raise
        except Exception as e:  # lint: broad-except-ok (re-raised with
            # the cause, naming the operator)
            raise WindFlowError(
                f"stateful operator '{self.name}': capturing the "
                f"wavefront's device loop failed: {type(e).__name__}: "
                f"{e}") from e
        c = {"graph": graph, "static": b, "depth": depth, "sig": None}
        self.cached[dev] = c
        return c


def _loop_route(kernels: bool, dev) -> bool:
    """Whether a wavefront step takes the device loop: the kernels
    resolved on (its gate, counted for the capture audit's WF907) and the
    batch on the card."""
    from windflow_tpu_torch.kernels.ffat_cuda import _gate
    return _gate("wavefront_loop", kernels) and dev.type == "cuda"


def _wavefront_body(fn: Callable, capacity: int, num_slots: int,
                    is_filter: bool, kernels: bool = False,
                    name: str = "stateful", loop: Optional[bool] = None):
    """``(state, payload, valid, slots) -> (state, payload, valid)``: the
    rank-wavefront apply over resolved slots (lanes with a slot >=
    num_slots are ignored).  An operator's table (:func:`_state_table`)
    is updated in place and comes back as the same tensors; any other
    table is copied once and the copy comes back.  No step allocates,
    fills or scans anything with ``num_slots`` rows then.  The body's
    ``last_depth`` is the batch's wavefront depth (a device scalar on the
    kernel route); ``counts`` holds per device the int64 ``[batches,
    passes, lanes]`` the steps added on the device (:func:`_count_step`).

    Two routes of one contract: the kernel route (``kernels`` resolved
    on and the batch on the card, or ``loop=True`` anywhere), the device
    loop of :class:`_ClassLoop`; and the plain version, the host loop
    below (the per-rank lane counts read on the host, one slice a rank),
    which runs on the CPU and under ``Config(cuda_kernels="0")``
    (``loop=False`` forces it)."""
    S = num_slots
    what = "stateful function"
    spec = {}          # the output carry's structure, from the first call
    klass = _ClassLoop(fn, capacity, num_slots, is_filter, what, name)
    tallies = {}

    def out_spec(payload, state):
        """The result structure of ``fn`` (the JAX package's
        ``jax.eval_shape``): from ``fn`` on one lane, once."""
        if "def" not in spec:
            one = tree_map(lambda a: a[:1], payload)
            cur = tree_map(lambda a: a[:1], state)
            res, _ = per_record2(fn, one, cur, 1)
            leaves, treedef = tree_flatten(res)
            # wfverify: ok (a structure cache filled on the first, eager
            # call, before any capture)
            spec["def"] = treedef
            # wfverify: ok (the same one-time cache)
            spec["leaves"] = [(l.dtype, tuple(l.shape[1:])) for l in leaves]
        return spec["def"], spec["leaves"]

    def body_fn(state, payload, valid, slots):
        dev = valid.device
        sort_key = _slot_key(valid, slots, S)
        order = auto_order(sort_key, S + 1).long()
        s_slots = sort_key[order]
        live = s_slots < S
        # rank = the lane's occurrence index within its key's run: its
        # sorted position less the run's start, looked up by the run's
        # number (a running sum of the run starts over the batch); lanes
        # that start no run write the spare entry ``capacity``
        pos = torch.arange(capacity, device=dev)
        starts = _seg_starts(s_slots)
        run = torch.cumsum(starts, 0) - 1
        first = torch.empty(capacity + 1, dtype=torch.int64, device=dev)
        first.index_copy_(0, torch.where(starts, run, capacity), pos)
        rank = torch.where(live, pos - first[run], capacity)
        cnt = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
        cnt.index_add_(0, rank, torch.ones_like(rank, dtype=torch.int32))
        _count_step(tallies, cnt[:capacity])
        use_loop = _loop_route(kernels, dev) if loop is None else loop
        if use_loop:
            # live lanes by (rank, slot): each wavefront a contiguous
            # slice; the loop reads the counts on the device
            w = order[torch.sort(rank, stable=True).indices]
            w_slots = slots.to(torch.int64)[w]
            treedef, leaf_spec = out_spec(payload, state) if not is_filter \
                else (None, None)
            st, outs = klass.run(state, payload, w, w_slots, cnt[:capacity],
                                 leaf_spec)
            body_fn.last_depth = klass.depth
            if is_filter:
                return st, payload, valid & outs
            return st, tree_unflatten(treedef, outs), valid
        counts = _rank_counts(cnt[:capacity])      # the step's host read
        body_fn.last_depth = len(counts)
        # live lanes by (rank, slot): each wavefront a contiguous slice
        w = order[torch.sort(rank, stable=True).indices]
        w_slots = slots.to(torch.int64)[w]
        w_payload = tree_map(lambda a: a[w], payload)
        st = state if _dump_tables(state, S) is not None \
            else tree_map(torch.clone, state)
        outs = []
        off = 0
        for c in counts:
            sl_slots = w_slots[off:off + c]
            cur = tree_map(lambda a: a[sl_slots], st)
            rec = tree_map(lambda a: a[off:off + c], w_payload)
            res, new = per_record2(fn, rec, cur, c)
            # slots within a rank are distinct: no write conflicts
            _update_rows(st, new, sl_slots, what)
            outs.append(res)
            off += c
        n_live = off
        dest = w[:n_live]
        if is_filter:
            keep = torch.ones(capacity, dtype=torch.bool, device=dev)
            if outs:
                keep.index_copy_(0, dest, torch.cat(
                    [r.to(torch.bool).reshape(-1) for r in outs]))
            return st, payload, valid & keep
        treedef, leaf_spec = out_spec(payload, state)
        leaves = []
        for i, (dt, trail) in enumerate(leaf_spec):
            full = torch.zeros((capacity,) + trail, dtype=dt, device=dev)
            if outs:
                full.index_copy_(0, dest, torch.cat(
                    [tree_flatten(r)[0][i].to(dt) for r in outs]))
            leaves.append(full)
        return st, tree_unflatten(treedef, leaves), valid

    body_fn.last_depth = 0
    body_fn.loop = klass
    body_fn.counts = tallies
    return body_fn


def _count_step(counts: dict, cnt) -> None:
    """Add one step's ``[1, passes, lanes]`` to its device's counter in
    ``counts`` (made on the step's first, eager call), on the device: the
    passes are the live ranks (one pass of the loop each), the lanes
    their sum.  A graph warm-up on scratch data (``ffat_cuda.uncounted``)
    adds nothing."""
    from windflow_tpu_torch.kernels.ffat_cuda import counting
    if not counting():
        return
    acc = counts.get(cnt.device)
    if acc is None:
        if cnt.is_cuda and torch.cuda.is_current_stream_capturing():
            raise WindFlowError("stateful counters: the first step of a "
                                "body runs eagerly, before any capture")
        acc = torch.zeros(3, dtype=torch.int64, device=cnt.device)
        counts[cnt.device] = acc
    acc.add_(torch.stack([torch.ones((), dtype=torch.int64,
                                     device=cnt.device),
                          torch.count_nonzero(cnt),
                          cnt.sum(dtype=torch.int64)]))


def _assoc_body(lift: Callable, comb: Callable, project: Callable,
                capacity: int, num_slots: int, is_filter: bool):
    """The log-depth body for an associative state update
    (``state' = comb(state, lift(record))``): a segmented inclusive scan
    folds each key's lifts in arrival order, ``project(record,
    state_incl)`` sees the state including the record's own lift (the
    keep bool for a filter), and each run's last lane writes the key's
    final state.  No host read; the segment-end scatter writes into a
    ``[S + 1]`` buffer whose last row takes every other lane."""
    S = num_slots

    def body_fn(state, payload, valid, slots):
        order, s_slots = _sort_by_slot(valid, slots, S)
        s_payload = tree_map(lambda a: a[order], payload)
        lifts = per_record(lift, s_payload, capacity)
        starts = _seg_starts(s_slots)

        def op(a, b):
            sa, va = a
            sb, vb = b
            combined = comb(va, vb)
            v = tree_map(lambda c, x: torch.where(_b(sb, c), x, c),
                         combined, vb)
            return sa | sb, v

        # invalid lanes all sit in the trailing sentinel segment
        _, prefix = associative_scan(op, (starts, lifts))
        gather = torch.clamp(s_slots, 0, S - 1).long()
        init = tree_map(lambda a: a[gather], state)
        state_incl = comb(init, prefix)
        s_out = per_record2(project, s_payload, state_incl, capacity)
        ends = torch.ones_like(starts)
        ends[:-1] = s_slots[:-1] != s_slots[1:]
        scat = torch.where(ends & (s_slots < S), s_slots, S).long()

        def persist(a, u):
            buf = torch.cat([a, a[:1]])
            buf.index_copy_(0, scat, _cast_update(u, a.dtype).reshape(
                (capacity,) + tuple(a.shape[1:])))
            return buf[:S]

        new_state = tree_map(persist, state, state_incl)
        inv = invert_perm(order).long()
        if is_filter:
            return new_state, payload, valid & s_out[inv].to(torch.bool)
        return new_state, tree_map(lambda a: a[inv], s_out), valid

    return body_fn


class _StatefulGPUBase(Operator):
    """Shared machinery: the state table and the interner live on the
    operator, shared by its replicas."""

    _is_filter = False
    replica_class = _GPUReplica

    @property
    def fixed_capacity_label(self):
        # the interning tables are padded to one batch capacity
        return type(self).__name__

    def __init__(self, fn: Callable, initial_state: Any, name: str,
                 parallelism: int, key_extractor: Callable,
                 num_key_slots: int = 4096, dense_keys: bool = False,
                 assoc: Optional[tuple] = None) -> None:
        if key_extractor is None:
            raise WindFlowError(
                f"stateful GPU operator '{name}' requires a key extractor "
                "(reference: stateful Map_GPU/Filter_GPU are keyed-only)")
        super().__init__(name, parallelism, routing=RoutingMode.KEYBY,
                         is_gpu=True, key_extractor=key_extractor)
        self.fn = fn
        self.num_key_slots = num_key_slots
        #: the extractor already returns slots in [0, num_key_slots): no
        #: interning and no host read (out-of-range keys masked invalid)
        self.dense_keys = dense_keys
        #: (lift, comb, project): the associative body replaces the
        #: wavefront; ``fn`` is then unused
        self.assoc = assoc
        self._state = _state_table(initial_state, num_key_slots)
        self._interner = KeyInterner()
        self._steps = {}      # per-capacity step cache
        self._bodies = {}
        #: compaction stats of the compacted route (device tensors)
        self._cstats = None
        #: the shard plane's sketch, updated in the dense-keys step, and
        #: its device state (made at the first step)
        self._sketch = None
        self._sk_state = None

    def key_space(self):
        # dense extractors are bounded by the slot table; interned key
        # spaces are not (slots follow arrival order)
        return self.num_key_slots if self.dense_keys else None

    def attach_shard_sketch(self, sketch) -> None:
        """Fold the shard plane's sketch update into the dense-keys step
        (graph build): the keys the step extracts on the card feed it,
        so the staging edge keeps no host key probe."""
        self._sketch = sketch
        sketch.register_device_state(lambda: self._sk_state)

    def _update_sketch(self, keys, valid) -> None:
        """One batch into the device sketch (no host read; a graph's
        warm-up on scratch data, ``ffat_cuda.uncounted``, adds nothing)."""
        from windflow_tpu_torch.kernels.ffat_cuda import counting
        from windflow_tpu_torch.monitoring.shard_ledger import (
            device_sketch_init, device_sketch_update)
        if not counting():
            return
        if self._sk_state is None:
            self._sk_state = device_sketch_init(self.parallelism,
                                                keys.device)
        device_sketch_update(self._sk_state, keys, valid, self.parallelism)

    # -- key compaction --------------------------------------------------------
    def enable_compaction(self, comp) -> None:
        """Attach a pinned KeyCompactor (graph build): the card-resident
        interner.  Keys are admitted on the host before their batch
        ships, the step looks the slots up, and a full table deactivates
        the compactor so the interner raises ``withNumKeySlots``'s error."""
        self._compactor = comp
        comp.register_device_stats(lambda: self._cstats)

    def _adopt_compactor_mapping(self) -> None:
        """After deactivation: fold the remap's key -> slot dict into the
        interner (slots were assigned contiguously in admission order),
        so the interning route keeps indexing the same state rows."""
        comp, self._compactor = self._compactor, None
        self._interner._ids.update(comp.export_mapping())

    # -- host key -> slot assignment -------------------------------------------
    def _intern(self, uniq: np.ndarray) -> np.ndarray:
        interner = self._interner
        slots = np.empty(len(uniq), np.int32)
        for i, k in enumerate(uniq):
            slots[i] = interner.intern(int(k))
        if len(interner) > self.num_key_slots:
            raise WindFlowError(
                f"operator '{self.name}': distinct keys exceed "
                f"num_key_slots={self.num_key_slots}; raise it via "
                "withNumKeySlots")
        return slots

    def _body_factory(self):
        """``(capacity, num_slots) -> body``: the mesh layer calls it with
        a key shard's slot count."""
        if self.assoc is not None:
            lift, comb, project = self.assoc
            return lambda cap, S: _assoc_body(lift, comb, project, cap, S,
                                              self._is_filter)
        from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
        kernels = resolve_kernels(self.config)
        return lambda cap, S: _wavefront_body(
            self.fn, cap, S, self._is_filter, kernels=kernels,
            name=self.name)

    def _body(self, capacity: int):
        body = self._bodies.get(capacity)
        if body is None:
            body = self._body_factory()(capacity, self.num_key_slots)
            self._bodies[capacity] = body
        return body

    def _get_sharded_step(self, capacity: int):
        """The mesh step; ``capacity`` is the staged batch's.  The table
        is sharded along ``key`` on first use."""
        step = self._steps.get(("mesh", capacity))
        if step is None:
            from windflow_tpu_torch.parallel import mesh as M
            from windflow_tpu_torch.parallel.multihost import process_count
            step = M.make_sharded_stateful_step(
                self.mesh, capacity * process_count(), self.num_key_slots,
                self._body_factory(), self.key_extractor, self.dense_keys,
                self._is_filter,
                ingest=getattr(self, "_ingest_mode", None) or "data",
                op_name=f"{self.name}.mesh")
            if not isinstance(self._state, M.Sharded):
                self._state = M.shard_state(self._state, self.mesh)
            self._steps[("mesh", capacity)] = step
        return step

    def _sharded_stateful_step(self, batch: DeviceBatch):
        step = self._get_sharded_step(batch.capacity)
        if self.dense_keys:
            return step(self._state, batch.payload, batch.valid)
        _, uniq_keys, uniq_slots = self._intern_batch(batch)
        return step(self._state, batch.payload, batch.valid, uniq_keys,
                    uniq_slots)

    @property
    def last_depth(self) -> int:
        """The last wavefront's depth (the hottest key's lanes in the
        batch); 0 on the associative body."""
        return self._read_depth()

    def _read_depth(self) -> int:
        """The kernel route keeps the depth on the card: this is a host
        read, made at stats cadence only, never in a step."""
        # wfverify: ok (the wavefront's depth, read at stats cadence)
        return max((int(getattr(b, "last_depth", 0))
                    for b in self._bodies.values()), default=0)

    def wavefront_counts(self) -> Optional[dict]:
        """``{batches, passes, lanes}`` the wavefront's steps added up on
        the device (the megastep's replays included): a host read, made
        at stats cadence only.  None on the associative body or before a
        step."""
        accs = [a for b in self._bodies.values()
                for a in getattr(b, "counts", {}).values()]
        if self.assoc is not None or not accs:
            return None
        # wfverify: ok (the wavefront's counters, read at stats cadence)
        tot = [sum(v) for v in zip(*(a.tolist() for a in accs))]
        return dict(zip(("batches", "passes", "lanes"), tot))

    def _keys(self, payload, capacity: int):
        return per_record(self.key_extractor, payload,
                          capacity).to(torch.int32)

    def _get_step(self, capacity: int):
        """The dense-keys step ``(state, payload, valid, keys)`` or the
        interning step ``(state, payload, valid, keys, uniq_keys,
        uniq_slots)``."""
        step = self._steps.get(capacity)
        if step is None:
            body = self._body(capacity)
            S = self.num_key_slots
            prelude = self._fused_prelude
            if prelude is not None and not self.dense_keys:
                # the planner fuses dense-key tails only: interning reads
                # the distinct keys on the host before the step
                raise WindFlowError(
                    f"stateful operator '{self.name}': whole-chain "
                    "fusion requires withDenseKeys")
            if self.dense_keys:
                def step(state, payload, valid, keys):
                    if prelude is not None:
                        # fused: the members run first; the edge's keys
                        # describe the pre-chain records
                        payload, valid = prelude(payload, valid)
                        keys = None
                    if keys is None:
                        keys = self._keys(payload, capacity)
                    if self._sketch is not None:
                        self._update_sketch(keys, valid)
                    ok = valid & (keys >= 0) & (keys < S)
                    return body(state, payload, ok, keys)
            else:
                def step(state, payload, valid, keys, uniq_keys, uniq_slots):
                    pos = torch.clamp(torch.searchsorted(uniq_keys, keys),
                                      0, capacity - 1)
                    return body(state, payload, valid, uniq_slots[pos])
            self._steps[capacity] = step
        return step

    def _get_compact_step(self, capacity: int):
        """The compacted step ``(state, payload, valid, keys, table_keys,
        table_slots, cstats)``: misses (keys the host never admitted) are
        masked invalid and counted."""
        step = self._steps.get(("compact", capacity))
        if step is None:
            from windflow_tpu_torch.parallel import compaction
            body = self._body(capacity)

            def step(state, payload, valid, keys, tk, tsl, cst):
                if keys is None:
                    keys = self._keys(payload, capacity)
                slots, hit = compaction.lookup_slots(tk, tsl, keys, valid)
                cst = compaction.cstats_update(cst, keys, hit, valid & ~hit)
                st, out, ov = body(state, payload, hit, slots)
                return st, out, ov, cst
            self._steps[("compact", capacity)] = step
        return step

    def key_space(self):
        """Dense extractors are bounded by the slot table; interned key
        spaces are unbounded."""
        return self.num_key_slots if self.dense_keys else None

    def _stateful_step(self, batch: DeviceBatch):
        if self.mesh is not None:
            return self._sharded_stateful_step(batch)
        cap = batch.capacity
        dev = batch.valid.device
        if tree_flatten(self._state)[0][0].device != dev:
            # the first step places the initial table; from pageable
            # memory the copy is staged before it returns, so no wait
            self._state = _place_state(self._state, dev, self.num_key_slots)
        if self.dense_keys:
            # no interning: no host read (the plain wavefront's rank
            # counts aside)
            return self._get_step(cap)(self._state, batch.payload,
                                       batch.valid, batch.keys)
        comp = self._compactor
        if comp is not None:
            if not comp.active:
                # a host observation path died: intern from here on,
                # keeping the slots already assigned
                self._adopt_compactor_mapping()
            else:
                from windflow_tpu_torch.parallel import compaction
                comp.on_batch()
                if self._cstats is None:
                    self._cstats = compaction.cstats_init(dev)
                tk, tsl = comp.tables()
                st, out, ov, self._cstats = self._get_compact_step(cap)(
                    self._state, batch.payload, batch.valid, batch.keys,
                    tk, tsl, self._cstats)
                return st, out, ov
        keys, uniq_keys, uniq_slots = self._intern_batch(batch)
        return self._get_step(cap)(self._state, batch.payload, batch.valid,
                                   keys, uniq_keys, uniq_slots)

    def _intern_batch(self, batch: DeviceBatch):
        """The interning route's host round trip: the key lane and the
        mask come to the host (one copy each), the distinct keys are
        interned, and their sorted key/slot tables (padded with the
        sentinel key and slot ``num_key_slots``) go back in one copy."""
        cap = batch.capacity
        keys = batch.keys if batch.keys is not None \
            else self._keys(batch.payload, cap)
        # wfverify: ok (the interning route's key and mask reads: its
        # design, keys are interned on the host)
        keys_np = keys.cpu().numpy()
        valid_np = batch.valid.cpu().numpy()  # wfverify: ok (as above)
        uniq = np.unique(keys_np[valid_np])
        uniq_slots = self._intern(uniq)
        from windflow_tpu_torch.parallel.compaction import upload_pair
        uk = np.full(cap, KEY_SENTINEL, np.int32)
        us = np.full(cap, self.num_key_slots, np.int32)
        uk[:len(uniq)] = uniq
        us[:len(uniq)] = uniq_slots
        return (keys.contiguous(),) + upload_pair(uk, us, keys.device)

    # -- durable state (windflow_tpu_torch/durability) -----------------------
    def snapshot_state(self):
        """The dense ``[num_key_slots, ...]`` state table (numpy copies)
        plus the host key→slot intern map and the compactor's remap: the
        values AND where each key lives, in the JAX package's blob
        layout.  The table exists from construction, so this snapshots
        even before the first batch."""
        from windflow_tpu_torch.parallel.mesh import Sharded
        from windflow_tpu_torch.utils.tree import host_copy
        return {
            "kind": "stateful_tpu",
            "state": host_copy(self._state.full()
                               if isinstance(self._state, Sharded)
                               else self._state),
            "interner": dict(self._interner._ids),
            "compactor": (self._compactor.snapshot()
                          if self._compactor is not None else None),
        }

    def restore_state(self, blob):
        """The inverse, on the graph's device, with the JAX package's
        cross-restores of the key compaction switch: a compacted
        checkpoint restored with compaction off folds the remap's
        key→slot map into the host interner (rows keep meaning the same
        keys); an interned checkpoint restored with compaction on keeps
        the interning route (a fresh remap would assign conflicting
        slots)."""
        from windflow_tpu_torch.utils.tree import place_tree
        if self.mesh is not None:
            # the table's content is shard-shape independent: a rescale
            # restore needs nothing but this placement
            from windflow_tpu_torch.parallel.mesh import shard_state
            self._state = shard_state(blob["state"], self.mesh)
        else:
            self._state = _rows(_extended(place_tree(
                blob["state"], self._state_device())), self.num_key_slots)
        self._interner._ids = dict(blob["interner"])
        cblob = blob.get("compactor")
        if cblob is not None and self._compactor is not None:
            self._compactor.restore(cblob)
        elif cblob is not None:
            self._interner._ids.update(
                {int(k): int(v) for k, v in cblob["key_slot"].items()})
        elif self._compactor is not None and self._interner._ids:
            self._compactor.deactivate()
            self._compactor = None

    def dump_stats(self) -> dict:
        st = super().dump_stats()
        if self._compactor is not None:
            st["Key_compaction"] = self._compactor.summary()
        if self.assoc is None and self._bodies:
            st["Wavefront_depth"] = self.last_depth
        return st


class StatefulMapGPU(_StatefulGPUBase):
    """Keyed stateful map on the card (reference stateful ``Map_GPU``):
    ``fn(record, state) -> (record, state)`` applied to each key's tuples
    in arrival order; the output record may add or drop fields."""

    _is_filter = False

    def __init__(self, fn, initial_state, name: str = "map_gpu",
                 parallelism: int = 1, key_extractor=None,
                 num_key_slots: int = 4096, dense_keys: bool = False,
                 assoc=None) -> None:
        super().__init__(fn, initial_state, name, parallelism, key_extractor,
                         num_key_slots, dense_keys=dense_keys, assoc=assoc)

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        self._state, out_payload, valid = self._stateful_step(batch)
        # fused chains may filter inside the step: the survivors are then
        # unknown until read
        size = None if self._fused_prelude is not None else batch._size
        return DeviceBatch(out_payload, batch.ts, valid,
                           watermark=batch.watermark, size=size,
                           frontier=batch.frontier, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)


class StatefulFilterGPU(_StatefulGPUBase):
    """Keyed stateful filter on the card (reference stateful
    ``Filter_GPU``): ``fn(record, state) -> (keep, state)``; dropped
    tuples leave the mask, their state updates still apply in order."""

    _is_filter = True

    def __init__(self, fn, initial_state, name: str = "filter_gpu",
                 parallelism: int = 1, key_extractor=None,
                 num_key_slots: int = 4096, dense_keys: bool = False,
                 assoc=None) -> None:
        super().__init__(fn, initial_state, name, parallelism, key_extractor,
                         num_key_slots, dense_keys=dense_keys, assoc=assoc)

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        self._state, out_payload, valid = self._stateful_step(batch)
        return DeviceBatch(out_payload, batch.ts, valid,
                           watermark=batch.watermark, size=None,
                           frontier=batch.frontier, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)
