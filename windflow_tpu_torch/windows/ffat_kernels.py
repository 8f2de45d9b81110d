"""FFAT step builders (the port of ``windflow_tpu/windows/
ffat_kernels.py``).

Pure functions over dicts of tensors.  Count-based windows:
``make_ffat_state`` lays out the dense per-key state, ``make_ffat_step``
builds the per-batch program and ``make_ffat_flush`` the EOS flush.
Time-based windows: ``make_ffat_tb_state`` lays out the pane ring and
``make_ffat_tb_step`` builds its per-batch program (the operator's EOS
flush loops it with an infinite watermark).  The arithmetic follows the
JAX package line by line, so the two produce the same records:

* ``lax.associative_scan`` has no torch twin; :func:`associative_scan`
  ports JAX's odd/even recursion, so the generic path keeps JAX's combine
  tree and float results match bit for bit;
* every scatter keeps its index in range — the dump row K takes the
  lanes JAX would drop (torch raises on an out-of-range index);
* ``.at[].add/max/min`` become ``index_add_`` and
  ``scatter_reduce_(include_self=True)`` for integer sums and for
  max/min, whose result no arrival order changes.  A declared
  floating-point sum does not go through atomics, whose order varies
  from run to run on the card: the lifts are put in a stable (cell,
  arrival) order and each cell's run is summed by a fixed doubling tree
  (:func:`_run_sums`), so the bits repeat from run to run (exactly-once
  replay needs that); they differ from JAX's sequential scatter-add by
  reassociation only;
* every int64 lane (``pane_base``, ``win_next``, ``n_fired``, the output
  slot iota) is int64 explicitly.

``kernels=True`` (``Config.cuda_kernels`` resolved by
``kernels.resolve_kernels``) routes the grouping and the declared-monoid
fold through the hand-written kernels where their gates hold.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.kernels.ffat_cuda import monoid_identity
from windflow_tpu_torch.utils.dtypes import cast_state_update
from windflow_tpu_torch.utils.tree import (per_record, tree_flatten,
                                           tree_map, tree_unflatten)
from windflow_tpu_torch.windows.grouping import (auto_order, invert_perm,
                                                 order_and_hist)


# ---------------------------------------------------------------------------
# scans and folds
# ---------------------------------------------------------------------------

def _slice(t: torch.Tensor, axis: int, start: int, stop=None, step: int = 1):
    ix = [slice(None)] * t.ndim
    ix[axis] = slice(start, stop, step)
    return t[tuple(ix)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[0::2] = a``, ``out[1::2] = b`` along ``axis`` (len(a) is
    len(b) or len(b) + 1)."""
    shape = list(a.shape)
    shape[axis] = a.shape[axis] + b.shape[axis]
    out = torch.empty(shape, dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    ix = [slice(None)] * a.ndim
    ix[axis] = slice(0, None, 2)
    out[tuple(ix)] = a
    ix[axis] = slice(1, None, 2)
    out[tuple(ix)] = b
    return out


def associative_scan(fn: Callable, elems, axis: int = 0):
    """Inclusive scan of the pytree ``elems`` with the associative ``fn``,
    evaluated with the SAME combine tree as ``jax.lax.associative_scan``
    (pairwise reduce, recurse on the odd half, fix up the even half)."""
    leaves, treedef = tree_flatten(elems)

    def combine(a, b):
        c = fn(tree_unflatten(treedef, a), tree_unflatten(treedef, b))
        return tree_flatten(c)[0]

    def scan(xs):
        n = xs[0].shape[axis]
        if n < 2:
            return xs
        reduced = combine([_slice(x, axis, 0, -1, 2) for x in xs],
                          [_slice(x, axis, 1, None, 2) for x in xs])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([_slice(e, axis, 0, -1) for e in odd],
                           [_slice(x, axis, 2, None, 2) for x in xs])
        else:
            even = combine(odd, [_slice(x, axis, 2, None, 2) for x in xs])
        even = [torch.cat([_slice(x, axis, 0, 1), r], axis)
                for x, r in zip(xs, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return tree_unflatten(treedef, scan(leaves))


def _b(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a bool mask against a leaf with trailing dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ref.ndim - mask.ndim))


def _where(mask, a, b):
    return torch.where(_b(mask, a), a, b)


def _group_order(ids, nbuckets: int, kernels: bool):
    """Stable grouping permutation of int32 ids in ``[0, nbuckets)``:
    through the grouping kernel where its gate holds, else the counting
    permutation up to DIGIT^2 buckets and the stable sort beyond
    (bit-identical either way: all order by (id, arrival))."""
    if kernels and fc.grouping_supported(int(ids.shape[0]), nbuckets):
        return fc.order_hist(ids, nbuckets)[0]
    return auto_order(ids, nbuckets)


def _group_order_hist(ids, nbuckets: int, kernels: bool):
    """Stable grouping permutation plus the ``[nbuckets]`` histogram;
    through the grouping kernel where its gate holds."""
    if kernels and fc.grouping_supported(int(ids.shape[0]), nbuckets):
        return fc.order_hist(ids, nbuckets)
    return order_and_hist(ids, nbuckets)


def _seg_scan(comb, flags, values):
    """Inclusive segmented scan: within each flagged segment, fold
    ``comb``.  ``flags`` [B] marks segment starts."""
    def op(a, b):
        fa, va = a
        fb, vb = b
        combined = comb(va, vb)
        v = tree_map(lambda c, nb: _where(fb, nb, c), combined, vb)
        return (fa | fb, v)

    _, scanned = associative_scan(op, (flags, values))
    return scanned


def _flag_comb(comb):
    """Flag-aware combine: invalid operands are skipped (an associative
    monoid without an identity element)."""
    def op(fa, va, fb, vb):
        both = comb(va, vb)
        v = tree_map(lambda c, xa, xb: _where(fb, _where(fa, c, xb), xa),
                     both, va, vb)
        return fa | fb, v
    return op


def _masked_reduce_last(comb, flags, values, axis: int):
    """Reduce ``values`` along ``axis`` with ``comb``, skipping entries
    whose flag is False; returns (any_flag, reduction)."""
    fc_ = _flag_comb(comb)
    f, v = associative_scan(lambda a, b: fc_(*a, *b), (flags, values),
                            axis=axis)

    def take(x):
        return x.select(axis, x.shape[axis] - 1)
    return take(f), tree_map(take, v)


def _shift_leaf(a: torch.Tensor, k: int, axis: int, fill=0):
    """Shift one leaf along ``axis`` by ``k`` toward higher indices,
    filling the vacated slots with ``fill``."""
    if k == 0:
        return a
    n = a.shape[axis]
    shape = list(a.shape)
    shape[axis] = min(k, n)
    pad = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    if k >= n:
        return pad
    return torch.cat([pad, _slice(a, axis, 0, n - k)], axis)


def _shift_right(flags, values, k: int, axis: int):
    if k == 0:
        return flags, values
    return (_shift_leaf(flags, k, axis, False),
            tree_map(lambda a: _shift_leaf(a, k, axis), values))


def _sliding_reduce(comb, flags, values, R: int, axis: int):
    """``out[i] = fold(comb)`` over the valid entries among positions
    ``[i-R+1, i]``: log2(R) dilated doublings build power-of-two window
    aggregates, then the binary decomposition of R stitches them from
    the newest end (the older chunk is comb's left operand)."""
    op = _flag_comb(comb)
    pow2 = [(flags, values)]
    width = 1
    while width * 2 <= R:
        f, v = pow2[-1]
        fs, vs = _shift_right(f, v, width, axis)
        pow2.append(op(fs, vs, f, v))
        width *= 2
    res = None
    offset = 0
    for j in range(len(pow2) - 1, -1, -1):
        w = 1 << j
        if R & w:
            f, v = _shift_right(*pow2[j], offset, axis)
            res = (f, v) if res is None else op(f, v, *res)
            offset += w
    return res


#: declared combiner monoids: kind -> elementwise combine
_MONOID_OPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}
_MONOID_KINDS = tuple(_MONOID_OPS)


def resolve_monoid(monoid):
    """Validate a declared monoid kind (None = generic combiner)."""
    if monoid is not None and monoid not in _MONOID_OPS:
        raise ValueError(f"unknown monoid {monoid!r}; "
                         f"expected one of {_MONOID_KINDS}")
    return monoid


def _ident(kind: str, like: torch.Tensor):
    """The monoid identity for ``like``'s dtype as a Python scalar: a
    ``torch.where`` operand, never a host-to-device copy."""
    return monoid_identity(kind, like.dtype)


def _monoid_fill(kind: str, flags, values):
    """Replace invalid entries with the monoid identity, leafwise."""
    return tree_map(lambda a: _where(flags, a, _ident(kind, a)), values)


def _monoid_scatter_(buf: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                     upd: torch.Tensor, kind: str) -> torch.Tensor:
    """``buf.at[row, col].add/max/min(upd)`` in place (every index in
    range).  On the card both run on atomics: ``index_add_`` rather than
    ``index_put_(accumulate=True)``, whose CUDA path sorts the indices
    first (measured ~100x slower at the main path's shapes, PERF.md)."""
    flat = buf.view(buf.shape[0] * buf.shape[1], *buf.shape[2:])
    cell = row * buf.shape[1] + col
    if kind == "sum":
        flat.index_add_(0, cell, upd)
        return buf
    idx = cell.reshape((-1,) + (1,) * (upd.ndim - 1)).expand(upd.shape)
    flat.scatter_reduce_(0, idx, upd, reduce="amax" if kind == "max"
                         else "amin", include_self=True)
    return buf


def _run_sums(vals: torch.Tensor, runs: torch.Tensor, max_run: int):
    """Inclusive sums of ``vals`` along dim 0, in place, within the runs
    of equal ids of the nondecreasing ``runs``, in a fixed order:
    ``ceil(log2(max_run))`` doubling steps, each lane adding the partial
    that ends ``d`` lanes back when that lane lies in its own run (+0.0
    otherwise).  A run's last lane then holds its sum for runs of up to
    ``max_run`` lanes.  No atomics: the same input gives the same bits
    on every run."""
    B = vals.shape[0]
    dev = vals.device
    steps = (min(max_run, B) - 1).bit_length()
    if steps <= 0:
        return vals
    # a lane's distance from its run's first lane (a binary search: the
    # 1-D int64 cummax is one block on the card, ~0.7 ms at 262,144),
    # against every step's reach at once
    dist = torch.arange(B, device=dev) - torch.searchsorted(runs, runs)
    reach = dist[None, :] >= (1 << torch.arange(steps, device=dev))[:, None]
    for j in range(steps):
        d = 1 << j
        # the partials d lanes back are read before the in-place add
        vals[d:].add_(_where(reach[j, d:], vals[:-d], 0))
    return vals


def _ordered_cell_sums(leaf: torch.Tensor, order: torch.Tensor,
                       scell: torch.Tensor, ncells: int, dump: int,
                       max_run: int) -> torch.Tensor:
    """The declared floating-point sum of ``leaf``'s lanes into ``ncells``
    flat cells, repeatable bit for bit: ``order`` gathers the lanes into
    (cell, arrival) order, ``scell`` [B] is each sorted lane's cell
    (nondecreasing; lanes to drop sit in the ``dump`` cell), each run is
    summed by :func:`_run_sums` and its last lane written to its cell.
    Empty cells hold 0."""
    sums = _run_sums(leaf[order], scell, max_run)
    true1 = torch.ones(1, dtype=torch.bool, device=leaf.device)
    ends = torch.cat([scell[1:] != scell[:-1], true1])
    buf = torch.zeros((ncells,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                      device=leaf.device)
    # a run's end lane is the only write to its cell (dump excepted)
    buf[torch.where(ends, scell, dump)] = _where(ends, sums, 0)
    return buf


def _ordered_sum_leaf(monoid: Optional[str], leaf: torch.Tensor) -> bool:
    """Whether a leaf's declared fold takes the ordered route: floating
    sums only (integer sums and max/min are order-independent)."""
    return monoid == "sum" and leaf.dtype.is_floating_point


def _sliding_reduce_plain(comb, flags, values, R: int, axis: int,
                          monoid: str):
    """Flagless dilated sliding fold for declared-monoid combiners:
    invalid entries take the monoid identity once, then the doubling runs
    on values alone."""
    zeroed = _monoid_fill(monoid, flags, values)

    def zshift(v, k):
        if k == 0:
            return v
        return tree_map(lambda a: _shift_leaf(
            a, k, axis, fill=monoid_identity(monoid, a.dtype)), v)

    pow2 = [zeroed]
    width = 1
    while width * 2 <= R:
        v = pow2[-1]
        pow2.append(comb(zshift(v, width), v))
        width *= 2
    res = None
    offset = 0
    for j in range(len(pow2) - 1, -1, -1):
        w = 1 << j
        if R & w:
            v = zshift(pow2[j], offset)
            res = v if res is None else comb(v, res)
            offset += w
    return res


# ---------------------------------------------------------------------------
# the CB step and flush
# ---------------------------------------------------------------------------

def make_ffat_step(capacity: int, K: int, P: int, R: int, D: int,
                   lift: Callable, comb: Callable,
                   key_fn: Optional[Callable],
                   monoid: Optional[str] = None, kernels: bool = False):
    """Build the FFAT per-batch step
    ``(state, payload, ts, valid) -> (state, out, out_valid, out_ts)``.

    Keys are dense ints in ``[0, K)``; invalid lanes and out-of-range keys
    are masked.  Panes hold P tuples, windows R panes, sliding by D panes.
    The output batch is COMPACTED: ``MAXO = capacity/(P*D) + 2K + 8``
    slots, filled by a K-long running sum + searchsorted over the per-key
    fired counts.

    Keys are grouped by the stable counting permutation (JAX's default
    ``rank_scatter`` grouping).  With a declared ``monoid`` ("sum" |
    "max" | "min") the step skips the permutation: each lane's within-key
    rank gives its pane cell and lifts scatter-COMBINE into the
    ``[K+1, NP1]`` grid (a floating-point sum instead goes through the
    grouping's destinations and sums each cell's run in a fixed order,
    :func:`_ordered_cell_sums`); the fold is then flagless."""
    monoid = resolve_monoid(monoid)
    NP1 = capacity // P + 2           # pane cells incl. continuation cell
    MAXO = capacity // (P * D) + 2 * K + 8
    scatter_combine = monoid is not None and K <= 4096

    def step(state, payload, ts, valid):
        B = capacity
        dev = valid.device
        i32 = dict(dtype=torch.int32, device=dev)
        if key_fn is not None:
            keys = per_record(key_fn, payload, B).to(torch.int32)
        else:
            keys = torch.zeros(B, **i32)
        ok = valid & (keys >= 0) & (keys < K)
        skey = torch.where(ok, keys, K).contiguous()

        if scatter_combine:
            if kernels and fc.grouping_supported(B, K + 1):
                dest, rank_u, hist = fc.grouping_rank_hist(skey, K + 1)
            else:
                from windflow_tpu_torch.windows.grouping import dense_rank
                rank_p, hist, _, _ = dense_rank(skey, K + 1)
                rank_u = rank_p[:B]
                dest = None
            n_k = hist[:K]
            lifts = per_record(lift, payload, B)
            fill0_u = state["cur_fill"][skey.clamp(max=K - 1).long()]
            col_u = torch.where(ok, (fill0_u + rank_u) // P, 0).long()
            row_u = skey.long()
            ordered = any(_ordered_sum_leaf(monoid, l)
                          for l in tree_flatten(lifts)[0])
            if ordered:
                # the stable grouping's destinations put each (key, pane)
                # cell's lanes in one run, in arrival order; a cell holds
                # at most P lanes
                if dest is None:
                    dest = (torch.cumsum(hist, 0) - hist)[skey.long()] \
                        + rank_u
                order = invert_perm(dest).long()
                scell = (row_u * NP1 + col_u)[order]

            def scat(leaf):
                if _ordered_sum_leaf(monoid, leaf):
                    return _ordered_cell_sums(
                        leaf, order, scell, (K + 1) * NP1, K * NP1,
                        P).view((K + 1, NP1) + tuple(leaf.shape[1:]))[:K]
                ident = _ident(monoid, leaf)
                buf = torch.full((K + 1, NP1) + tuple(leaf.shape[1:]),
                                 monoid_identity(monoid, leaf.dtype),
                                 dtype=leaf.dtype, device=dev)
                return _monoid_scatter_(buf, row_u, col_u,
                                        _where(ok, leaf, ident), monoid)[:K]
            cells = tree_map(scat, lifts)

            # the carried partial pane merges by the declared op (empty
            # cells hold the monoid identity)
            def merge0(cur_leaf, cell_leaf):
                upd = _where(state["cur_valid"], cur_leaf,
                             _ident(monoid, cur_leaf))
                upd = cast_state_update(upd, cell_leaf.dtype,
                                        "FFAT pane merge")
                cell_leaf[:, 0] = _MONOID_OPS[monoid](cell_leaf[:, 0], upd)
                return cell_leaf
            cells = tree_map(merge0, state["cur"], cells)
        else:
            # after a STABLE grouping by dense key, bucket b's lanes occupy
            # [start_b, start_b + hist_b): the within-key rank is index
            # arithmetic off the histogram
            order, hist = _group_order_hist(skey, K + 1, kernels)
            order = order.long()
            sk = skey[order]
            slift = tree_map(lambda a: a[order],
                             per_record(lift, payload, B))
            pos = torch.arange(B, device=dev)
            bucket_start = torch.cumsum(hist, 0) - hist      # exclusive
            rank = pos - bucket_start[sk.long()]
            starts = rank == 0

            n_k = hist[:K]
            fill0 = state["cur_fill"][sk.clamp(max=K - 1).long()]
            pane_rel = ((fill0 + rank) // P).to(torch.int32)

            true1 = torch.ones(1, dtype=torch.bool, device=dev)
            pane_starts = starts | torch.cat(
                [true1, pane_rel[1:] != pane_rel[:-1]])
            scanned = _seg_scan(comb, pane_starts, slift)
            ends = torch.cat(
                [(sk[1:] != sk[:-1]) | (pane_rel[1:] != pane_rel[:-1]),
                 true1])
            # scatter segment-end partials into dense [K+1, NP1] cells;
            # every non-end lane lands in the dump row K
            row = torch.where(ends, sk, K).long()
            col = torch.where(ends, pane_rel, 0).long()

            def scat(leaf):
                buf = torch.zeros((K + 1, NP1) + tuple(leaf.shape[1:]),
                                  dtype=leaf.dtype, device=dev)
                buf[row, col] = _where(ends, leaf,
                                       torch.zeros((), dtype=leaf.dtype,
                                                   device=dev))
                return buf[:K]
            cells = tree_map(scat, scanned)
            has = torch.zeros((K + 1, NP1), dtype=torch.bool, device=dev)
            has[row, col] = ends
            cell_has = has[:K]

            # merge the continuation cell with the carried partial pane;
            # comb is a WHOLE-PYTREE combiner, so it runs once on the tree
            cell0 = tree_map(lambda cl: cl[:, 0], cells)
            both0 = comb(state["cur"], cell0)

            def merge0(cur_leaf, cell_leaf, both_leaf):
                use_cur = state["cur_valid"]
                use_cell = cell_has[:, 0]
                v = _where(use_cur & use_cell, both_leaf,
                           _where(use_cur, cur_leaf, cell_leaf[:, 0]))
                cell_leaf[:, 0] = cast_state_update(v, cell_leaf.dtype,
                                                    "FFAT pane merge")
                return cell_leaf
            cells = tree_map(merge0, state["cur"], cells, both0)

        m_k = ((state["cur_fill"] + n_k) // P).to(torch.int32)
        new_fill = ((state["cur_fill"] + n_k) % P).to(torch.int32)

        # full pane sequence: carry (R-1 trailing) + this batch's panes
        full = tree_map(lambda c, p: torch.cat([c, p], 1),
                        state["carry"], cells)
        col_ix = torch.arange(NP1, device=dev)[None, :]
        pane_valid = col_ix < m_k[:, None]
        full_valid = torch.cat([state["carry_valid"], pane_valid], 1)

        # fire windows: key k fires ends e = win_next[k] + j*D while
        # e <= done[k] — a per-key prefix
        done = state["pane_base"] + m_k.to(torch.int64)
        if monoid is not None:
            if kernels and fc.fold_supported(full, R, monoid):
                swin = fc.sliding_fold(full, full_valid, R, monoid)
            else:
                swin = _sliding_reduce_plain(comb, full_valid, full, R,
                                             axis=1, monoid=monoid)
        else:
            _, swin = _sliding_reduce(comb, full_valid, full, R, axis=1)

        n_fired = torch.clamp((done - state["win_next"]) // D + 1, min=0)
        new_win_next = state["win_next"] + n_fired * D

        # new carry: panes [pane_base+m_k-(R-1), pane_base+m_k)
        cidx = (m_k[:, None] + torch.arange(R - 1, dtype=torch.int32,
                                            device=dev)[None, :]).long()

        def gather_cols(a, idx):
            idx = idx.reshape(tuple(idx.shape) + (1,) * (a.ndim - 2))
            return torch.gather(a, 1, idx.expand(
                tuple(idx.shape[:2]) + tuple(a.shape[2:])))
        new_carry = tree_map(lambda a: gather_cols(a, cidx), full)
        new_carry_valid = torch.gather(full_valid, 1, cidx)
        new_cur = tree_map(
            lambda c: gather_cols(c, m_k[:, None].long())[:, 0], cells)
        new_cur_valid = new_fill > 0

        new_state = {
            "carry": new_carry,
            "carry_valid": new_carry_valid,
            "cur": new_cur,
            "cur_valid": new_cur_valid,
            "cur_fill": new_fill,
            "pane_base": done,
            "win_next": new_win_next,
        }

        # compacted output: slot i belongs to the key whose fired-count
        # running sum first exceeds i
        offs = torch.cumsum(n_fired, 0)                        # int64 [K]
        n_out = offs[K - 1]
        i_slot = torch.arange(MAXO, dtype=torch.int64, device=dev)
        k_out = torch.searchsorted(offs, i_slot, right=True) \
            .to(torch.int32)
        k_c = k_out.clamp(max=K - 1)
        k_l = k_c.long()
        j_out = i_slot - (offs[k_l] - n_fired[k_l])            # rank in key
        e_out = state["win_next"][k_l] + j_out * D
        widx_out = torch.clamp(
            (e_out - state["pane_base"][k_l] + (R - 2)).to(torch.int32),
            0, R - 1 + NP1 - 1).long()
        wvals_out = tree_map(lambda a: a[k_l, widx_out], swin)
        out = {
            "key": k_c,
            "wid": torch.div(e_out - R, D, rounding_mode="floor"),
            "value": wvals_out,
        }
        out_valid = i_slot < n_out
        batch_ts = torch.where(valid, ts, torch.zeros((), dtype=ts.dtype,
                                                       device=dev)).max()
        out_ts = torch.where(out_valid, batch_ts,
                             torch.zeros((), dtype=ts.dtype, device=dev))
        return new_state, out, out_valid, out_ts

    return step


def make_ffat_flush(K: int, P: int, R: int, D: int, comb: Callable):
    """Build the CB EOS flush ``state -> (out, fired, ts)``: fire every
    remaining partial window from the carried pane history."""
    MWF = R // D + 2

    def flush(state):
        dev = state["cur_fill"].device
        has_cur = state["cur_valid"]
        total = state["pane_base"] + has_cur.to(torch.int64)
        # available pane history: carry (R-1) + cur -> [K, R]
        hist = tree_map(lambda c, cur: torch.cat([c, cur[:, None]], 1),
                        state["carry"], state["cur"])
        hist_valid = torch.cat([state["carry_valid"], has_cur[:, None]], 1)
        # hist column i holds pane (pane_base - (R-1) + i)
        j = torch.arange(MWF, dtype=torch.int64, device=dev)
        e = state["win_next"][:, None] + j[None, :] * D
        start = e - R
        fire = start < total[:, None]
        ar = torch.arange(R, dtype=torch.int64, device=dev)[None, None, :]
        lidx = start[:, :, None] + ar \
            - state["pane_base"][:, None, None] + (R - 1)
        inb = (lidx >= 0) & (lidx < R)
        lidx_c = torch.clamp(lidx, 0, R - 1)
        pane_ok = torch.gather(
            hist_valid[:, None].expand(K, MWF, R), 2, lidx_c) & inb
        pane_abs = start[:, :, None] + ar
        pane_ok = pane_ok & (pane_abs < total[:, None, None]) \
            & (pane_abs >= 0)

        def gather_leaf(a):
            expanded = a[:, None].expand((K, MWF) + tuple(a.shape[1:]))
            idx = lidx_c.reshape((K, MWF, R) + (1,) * (a.ndim - 2))
            idx = idx.expand((K, MWF, R) + tuple(a.shape[2:]))
            return torch.gather(expanded, 2, idx)
        wpanes = tree_map(gather_leaf, hist)
        any_ok, wvals = _masked_reduce_last(comb, pane_ok, wpanes, axis=2)
        fired = fire & any_ok
        wid = torch.div(e - R, D, rounding_mode="floor")
        keys = torch.arange(K, dtype=torch.int32, device=dev)[:, None] \
            .expand(K, MWF)
        out = {
            "key": keys.reshape(-1),
            "wid": wid.reshape(-1),
            "value": tree_map(
                lambda a: a.reshape((K * MWF,) + tuple(a.shape[2:])), wvals),
        }
        ts = torch.zeros(K * MWF, dtype=torch.int64, device=dev)
        return out, fired.reshape(-1), ts

    return flush


# ---------------------------------------------------------------------------
# the TB state and step
# ---------------------------------------------------------------------------

#: the TB step's pane sentinels (JAX: ``1 << 60``)
_FAR = 1 << 60


def make_ffat_tb_state(agg_spec, K: int, NP: int, device=None):
    """Dense pane-ring state for time-based FFAT: column ``i`` of
    ``cells`` holds the aggregate of time pane ``base + i`` (pane =
    ``ts // P_usec``) for each key.  All keys share the pane clock, so
    ``base``, ``win_next`` and ``max_seen`` are 0-d int64 tensors on the
    device; ``horizon`` is the per-key overflow taint and the last three
    fields count late tuples, evicted pane cells and suppressed
    windows."""
    def i64(v, shape=()):
        return torch.full(shape, v, dtype=torch.int64, device=device)
    return {
        "cells": tree_map(lambda s: torch.zeros((K, NP) + tuple(s.shape),
                                                dtype=s.dtype, device=device),
                          agg_spec),
        "cell_valid": torch.zeros((K, NP), dtype=torch.bool, device=device),
        "base": i64(0),                  # pane index of column 0
        "win_next": i64(0),              # next unfired window id
        "max_seen": i64(-_FAR),          # newest data pane ever placed
        "horizon": i64(-_FAR, (K,)),     # one past the newest evicted pane
        "n_late": i64(0),
        "n_evicted": i64(0),
        "n_win_dropped": i64(0),
    }


def make_ffat_tb_step(capacity: int, K: int, P_usec: int, R: int, D: int,
                      NP: int, lift: Callable, comb: Callable,
                      key_fn: Optional[Callable],
                      drop_tainted: bool = False,
                      monoid: Optional[str] = None, kernels: bool = False):
    """Build the time-based FFAT per-batch step ``(state, payload, ts,
    valid, wm_pane) -> (state, out, fired, out_ts, n_advanced)``
    (``make_ffat_tb_step`` of the JAX package, pass for pass).

    Window ``w`` covers panes ``[w*D, w*D + R)`` and fires once the
    lateness-adjusted watermark ``wm_pane`` (a host int) passes its end.
    Two fire passes A run before placement, against ``min(wm_pane,
    oldest batch pane)``; the capacity roll then makes room for the
    batch's newest pane (evicted data panes count in ``n_evicted`` and
    taint their key's ``horizon``); the batch is placed; pass B fires
    what it completed.  ``drop_tainted`` suppresses (and counts) windows
    that lost a data pane to an eviction.

    Where JAX folds under ``lax.cond`` only when a pass fires, this step
    folds on every pass: reading ``n_fired`` on the host would stall the
    stream three times a step.  With nothing fired every ``fired`` lane
    is False and the counters are those of the no-fold branch; only the
    values of unfired lanes differ, and egress never emits them.  Nothing
    here reads the device on the host: ``base``, ``win_next`` and
    ``max_seen`` stay 0-d tensors, the rolls gather by a device
    ``arange``, and every scalar operand is a Python number.

    Placement: a declared ``monoid`` scatter-combines lifts straight
    into the ring (a TB pane cell is timestamp arithmetic, no grouping),
    except a floating-point sum, which orders the lanes by (key, pane)
    id first (the grouping kernel under its gate, the stable sort
    beyond) and sums each run in a fixed order (:func:`_ordered_cell_sums`);
    otherwise the batch is grouped by its (key, pane) id — the grouping
    kernel for ``K*NP + 1 <= 4096`` ids under ``kernels``, the radix
    counting sort up to DIGIT^2, the stable sort beyond (int64 ids at
    ``K*NP + 1 >= 2^31``) — and a segmented scan folds each run."""
    monoid = resolve_monoid(monoid)
    MW = NP // D + 2
    N_PASSES = 3                     # A1, A2 (pre-place), B (post-place)
    NIDS = K * NP + 1

    def roll_left(flags, values, k):
        # advance the ring by the device scalar k; the vacated tail is
        # invalid and holds copies of the last column, as JAX's clipped
        # take leaves it
        idx = torch.arange(NP, dtype=torch.int64, device=flags.device) + k
        idxc = torch.clamp(idx, 0, NP - 1)
        f = flags.index_select(1, idxc) & (idx < NP)[None, :]
        v = tree_map(lambda a: a.index_select(1, idxc), values)
        return f, v

    def fire_pass(cells, cell_valid, base, win_next, frontier, max_seen,
                  horizon):
        """Fire windows ending <= frontier whose end pane is in the ring
        and that start at or before the newest data pane; returns the
        rolled ring and the pass's outputs."""
        j = torch.arange(MW, dtype=torch.int64, device=cell_valid.device)
        w = win_next + j
        end_local = w * D + R - 1 - base                       # [MW]
        fire = ((w * D + R) <= frontier) & (end_local < NP) \
            & (w * D <= max_seen)                              # a prefix
        # end_local < 0 only when a capacity roll evicted the whole
        # window: it advances but never emits
        emitable = fire & (end_local >= 0)
        eidx = torch.clamp(end_local, 0, NP - 1)
        n_fired = fire.sum(dtype=torch.int64)
        sflag, swin = _sliding_reduce(comb, cell_valid, cells, R, axis=1)
        wvals = tree_map(lambda a: a.index_select(1, eidx), swin)
        f = emitable[None, :] & sflag.index_select(1, eidx)
        n_drop = torch.zeros((), dtype=torch.int64, device=f.device)
        if drop_tainted:
            clean = (w * D)[None, :] >= horizon[:, None]
            gone = (fire & ~emitable)[None, :] & ~clean
            n_drop = (f & ~clean).sum(dtype=torch.int64) \
                + gone.sum(dtype=torch.int64)
            f = f & clean
        new_next = win_next + n_fired
        shift = torch.clamp(new_next * D - base, 0, NP)
        cell_valid, cells = roll_left(cell_valid, cells, shift)
        return (cells, cell_valid, base + shift, new_next,
                f, wvals, w, n_fired, n_drop)

    def step(state, payload, ts, valid, wm_pane: int):
        B = capacity
        dev = valid.device
        if key_fn is not None:
            keys = per_record(key_fn, payload, B).to(torch.int32)
        else:
            keys = torch.zeros(B, dtype=torch.int32, device=dev)
        ok = valid & (keys >= 0) & (keys < K)
        pane = torch.div(ts.to(torch.int64), P_usec, rounding_mode="floor")
        if D > R:
            # hopping windows with gaps: pane p belongs to a window iff
            # p mod D < R; the others are never placed or counted
            ok = ok & (torch.remainder(pane, D) < R)

        # 1. pass A (twice): fire everything no tuple of this batch can
        # touch; the second pass reaches the ends the first one's roll
        # brought into the ring
        min_pane = torch.where(ok, pane, _FAR).min()
        frontier_a = torch.clamp(min_pane, max=wm_pane)
        cells, cell_valid = state["cells"], state["cell_valid"]
        base, win_next = state["base"], state["win_next"]
        passes = []
        n_win_dropped = state["n_win_dropped"]
        for _ in range(2):
            (cells, cell_valid, base, win_next,
             fired_i, wvals_i, w_i, n_i, nd_i) = fire_pass(
                cells, cell_valid, base, win_next, frontier_a,
                state["max_seen"], state["horizon"])
            passes.append((fired_i, wvals_i, w_i, n_i))
            n_win_dropped = n_win_dropped + nd_i

        # 2. capacity roll: make room for this batch's newest pane
        max_pane = torch.where(ok, pane, base).max()
        max_seen = torch.maximum(state["max_seen"],
                                 torch.where(ok, pane, -_FAR).max())
        shift_cap = torch.clamp(max_pane - base - (NP - 1), min=0)
        col = torch.arange(NP, dtype=torch.int64, device=dev)[None, :]
        evict_mask = cell_valid & (col < shift_cap)
        evicted = evict_mask.sum(dtype=torch.int64)
        horizon = torch.maximum(
            state["horizon"],
            torch.where(evict_mask, base + col + 1, -_FAR).amax(dim=1))
        cell_valid, cells = roll_left(cell_valid, cells, shift_cap)
        base = base + shift_cap

        # 3. place the batch
        rel = pane - base
        late = ok & (rel < 0)
        ok = ok & (rel >= 0)
        rel_c = torch.clamp(rel, 0, NP - 1)
        lifts = per_record(lift, payload, B)
        if monoid is not None:
            # a pane cell is timestamp arithmetic: lifts scatter-combine
            # straight into the ring, absent cells hold the identity
            row_u = torch.where(ok, keys.to(torch.int64), K)
            col_u = torch.where(ok, rel_c, 0)
            if any(_ordered_sum_leaf(monoid, l)
                   for l in tree_flatten(lifts)[0]):
                # (key, pane) cells in arrival order: the grouping kernel
                # under its gate, the stable sort beyond
                sid = row_u * NP + col_u
                if kernels and fc.grouping_supported(B, NIDS):
                    order = fc.order_hist(sid.to(torch.int32).contiguous(),
                                          NIDS)[0].long()
                else:
                    order = torch.sort(
                        sid.to(torch.int32) if NIDS < (1 << 31) else sid,
                        stable=True).indices
                ssid = sid[order]

            def scat(leaf):
                if _ordered_sum_leaf(monoid, leaf):
                    return _ordered_cell_sums(
                        leaf, order, ssid, (K + 1) * NP, K * NP,
                        B).view((K + 1, NP) + tuple(leaf.shape[1:]))[:K]
                ident = monoid_identity(monoid, leaf.dtype)
                buf = torch.full((K + 1, NP) + tuple(leaf.shape[1:]), ident,
                                 dtype=leaf.dtype, device=dev)
                return _monoid_scatter_(buf, row_u, col_u,
                                        _where(ok, leaf, ident), monoid)[:K]
            partial = tree_map(scat, lifts)
            has = torch.zeros((K + 1) * NP, dtype=torch.int32, device=dev)
            has.index_add_(0, row_u * NP + col_u, ok.to(torch.int32))
            partial_has = has.view(K + 1, NP)[:K] > 0
            mop = _MONOID_OPS[monoid]

            def merge_m(old_leaf, new_leaf):
                old = _where(cell_valid, old_leaf,
                             monoid_identity(monoid, old_leaf.dtype))
                return mop(new_leaf, old)
            cells = tree_map(merge_m, cells, partial)
        else:
            sid = torch.where(ok, keys.to(torch.int64) * NP + rel_c, K * NP)
            if NIDS < (1 << 31):         # counting ids are int32
                order = _group_order(sid.to(torch.int32).contiguous(), NIDS,
                                     kernels).long()
            else:
                order = torch.sort(sid, stable=True).indices
            ssid = sid[order]
            slift = tree_map(lambda a: a[order], lifts)
            true1 = torch.ones(1, dtype=torch.bool, device=dev)
            brk = ssid[1:] != ssid[:-1]
            scanned = _seg_scan(comb, torch.cat([true1, brk]), slift)
            ends = torch.cat([brk, true1])
            row = torch.where(ends, torch.div(ssid, NP, rounding_mode="floor"),
                              K)
            col_e = torch.where(ends, torch.remainder(ssid, NP), 0)

            def scat(leaf):
                buf = torch.zeros((K + 1, NP) + tuple(leaf.shape[1:]),
                                  dtype=leaf.dtype, device=dev)
                buf[row, col_e] = _where(ends, leaf, 0)
                return buf[:K]
            partial = tree_map(scat, scanned)
            has = torch.zeros((K + 1, NP), dtype=torch.bool, device=dev)
            has[row, col_e] = ends
            partial_has = has[:K]
            # comb is a whole-pytree combiner: it runs once on the tree
            both_cells = comb(cells, partial)

            def merge(old_leaf, new_leaf, both_leaf):
                return _where(cell_valid & partial_has, both_leaf,
                              _where(partial_has, new_leaf, old_leaf))
            cells = tree_map(merge, cells, partial, both_cells)
        cell_valid = cell_valid | partial_has

        # 4. pass B: fire what this batch completed under the watermark
        (cells, cell_valid, base, win_next,
         fired_b, wvals_b, w_b, n_b, nd_b) = fire_pass(
            cells, cell_valid, base, win_next, wm_pane, max_seen, horizon)
        passes.append((fired_b, wvals_b, w_b, n_b))
        n_win_dropped = n_win_dropped + nd_b

        new_state = {
            "cells": cells,
            "cell_valid": cell_valid,
            "base": base,
            "win_next": win_next,
            "max_seen": max_seen,
            "horizon": horizon,
            "n_late": state["n_late"] + late.sum(dtype=torch.int64),
            "n_evicted": state["n_evicted"] + evicted,
            "n_win_dropped": n_win_dropped,
        }
        # outputs: passes A1, A2, then B, [K, N_PASSES*MW] flattened
        NM = N_PASSES * MW
        w2 = torch.cat([p[2] for p in passes])
        fired = torch.cat([p[0] for p in passes], 1)
        wvals = tree_map(lambda *leaves: torch.cat(leaves, 1),
                         *[p[1] for p in passes])
        out_ts = (w2 * D + R) * P_usec - 1                     # end - 1
        out = {
            "key": torch.arange(K, dtype=torch.int32, device=dev)[:, None]
            .expand(K, NM).reshape(-1),
            "wid": w2[None, :].expand(K, NM).reshape(-1),
            "value": tree_map(
                lambda a: a.reshape((K * NM,) + tuple(a.shape[2:])), wvals),
        }
        n_adv = passes[0][3] + passes[1][3] + passes[2][3]
        return new_state, out, fired.reshape(-1), \
            out_ts[None, :].expand(K, NM).reshape(-1), n_adv

    return step


def make_ffat_state(agg_spec, K: int, R: int, device=None):
    """Dense per-key FFAT state over a static key space ``[0, K)``;
    ``agg_spec`` is a pytree of zero tensors with one aggregate's shape
    and dtype."""
    def zeros(shape):
        return tree_map(lambda s: torch.zeros(shape + tuple(s.shape),
                                              dtype=s.dtype, device=device),
                        agg_spec)
    return {
        "carry": zeros((K, R - 1)),               # trailing R-1 panes
        "carry_valid": torch.zeros((K, R - 1), dtype=torch.bool,
                                   device=device),
        "cur": zeros((K,)),                       # partial pane aggregate
        "cur_valid": torch.zeros(K, dtype=torch.bool, device=device),
        "cur_fill": torch.zeros(K, dtype=torch.int32, device=device),
        "pane_base": torch.zeros(K, dtype=torch.int64, device=device),
        "win_next": torch.full((K,), R, dtype=torch.int64, device=device),
    }


def agg_spec_for(lift: Callable, payload_tree) -> Any:
    """Shape/dtype skeleton of one aggregate: ``lift`` evaluated on the
    first lane of a batch payload."""
    one = tree_map(lambda a: a[:1], payload_tree)
    spec = per_record(lift, one, 1)
    return tree_map(lambda s: torch.zeros(tuple(s.shape[1:]),
                                          dtype=s.dtype), spec)
