"""The dense-table kernel of the keyed reduce: wrapper, plain torch
version, gates and the per-leaf front door.

The port of ``dense_monoid_table`` and ``routed_monoid_tables``
(``windflow_tpu/kernels/pallas_ffat.py:449-615``), the third Pallas
kernel: for each leaf, ``table[s] = fold(op, init, leaf[lanes with row
== s])`` over ``s in [0, nslots)``.  ``csrc/dense_monoid_table.cu``
computes it on the card.  As for the FFAT kernels (``ffat_cuda.py``,
whose counters this module shares), the wrapper takes the plain version
for a tensor on the CPU and, for a CUDA tensor, launches the kernel or
raises.

Exactness: max, min, integer and bool folds equal the plain version bit
for bit on the card.  An f32 sum is the same from run to run (no global
atomics; partial tables fold in tile order) and exact on integer-valued
data below 2^24; otherwise it reassociates the plain scatter-add, the
declared-"sum" tolerance of ``pallas_ffat.py:40-46``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Sequence

import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.utils.tree import tree_flatten, tree_unflatten

#: slot-space ceiling (the Pallas gate, MAX_BUCKETS)
MAX_SLOTS = 4096
#: lane-count ceiling (the Pallas gate, MAX_LANES)
MAX_LANES = 1 << 22
#: widest packed [B, W] leaf the kernel takes
MAX_WIDTH = 8
#: lanes a tile (one block of the kernel's first pass) folds
TABLE_TILE = 2048
#: most tiles of one call
TABLE_MAX_TILES = 256
#: most columns of one launch (the kernel's MAX_COLS)
TABLE_MAX_COLS = 32
#: ceiling of the partial tables, in 8-byte words (32 MB)
PARTIAL_WORDS = 1 << 22

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1, torch.int64: 2,
               torch.bool: 3}
_OP_CODE = {"sum": 0, "max": 1, "min": 2}


def table_supported(n: int, nslots: int) -> bool:
    """Slot-space / lane-count gate of the kernel, as in Pallas: beyond
    it the torch scatter keeps the job."""
    return fc._gate("dense_monoid_table",
                    1 <= nslots <= MAX_SLOTS and 0 < n <= MAX_LANES)


def table_leaf_ok(shape, dtype) -> bool:
    """Per-leaf gate: ``[B]`` lanes or packed ``[B, W <= 8]`` columns of
    f32, i32, i64 or bool (so the int64 packed carrier and the int64 ts
    column ride the kernel).  Other leaves keep the torch scatter —
    values unchanged either way."""
    if len(shape) not in (1, 2):
        return False
    if len(shape) == 2 and shape[1] > MAX_WIDTH:
        return False
    return dtype in _DTYPE_CODE


def table_leaf_plain(row: torch.Tensor, leaf: torch.Tensor, op: str,
                     init, nslots: int) -> torch.Tensor:
    """One leaf of :func:`dense_monoid_table_plain`: the ``buf.at[row]``
    scatter into an ``[nslots + 1]`` buffer whose last row is the dump
    row for lanes outside ``[0, nslots)``.  Bool folds as int 0/1 (sum
    and max are OR, min is AND)."""
    S = int(nslots)
    dump = torch.where((row >= 0) & (row < S), row,
                       torch.full_like(row, S)).long()
    work = leaf
    if leaf.dtype == torch.bool:
        work = leaf.to(torch.int32)
        op = "max" if op == "sum" else op
    buf = torch.full((S + 1,) + tuple(leaf.shape[1:]), init,
                     dtype=work.dtype, device=leaf.device)
    if op == "sum":
        buf.index_add_(0, dump, work)
    else:
        idx = dump.reshape((-1,) + (1,) * (work.ndim - 1)).expand(work.shape)
        buf.scatter_reduce_(0, idx, work, reduce="amax" if op == "max"
                            else "amin", include_self=True)
    out = buf[:S]
    return out.bool() if leaf.dtype == torch.bool else out


def dense_monoid_table_plain(row: torch.Tensor, leaves: Sequence,
                             ops: Sequence[str], inits: Sequence,
                             nslots: int) -> List[torch.Tensor]:
    """Plain torch version of :func:`dense_monoid_table`."""
    return [table_leaf_plain(row, l, op, init, nslots)
            for l, op, init in zip(leaves, ops, inits)]


def _init_bits(init, dtype: torch.dtype) -> int:
    """A Python scalar init as the 64-bit word the kernel reads: f32 as
    its 32-bit pattern, bool as 0/1, integers as themselves."""
    if dtype == torch.float32:
        return struct.unpack("<I", struct.pack("<f", float(init)))[0]
    if dtype == torch.bool:
        return int(bool(init))
    return int(init)


def dense_monoid_table(row: torch.Tensor, leaves: Sequence,
                       ops: Sequence[str], inits: Sequence,
                       nslots: int) -> List[torch.Tensor]:
    """Segmented reduce into dense slot tables: for each leaf,
    ``table[s] = fold(op, init, leaf[lanes with row == s])`` over ``s in
    [0, nslots)``; lanes whose ``row`` lies outside contribute nothing.
    Leaves are ``[B]`` lanes or ``[B, W]`` packed columns, each with its
    own op ("sum" | "max" | "min") and init (a Python scalar, passed to
    the kernel as a 64-bit value), so payload tables, the ts max and the
    liveness count ride one call.  Returns one ``[nslots]`` /
    ``[nslots, W]`` table per leaf, in the leaf's dtype.

    On the card one call is one entry into the library, which launches
    both passes over all columns (a second entry per 32 columns); the
    partial tables take at most 8 bytes a column, tile and slot."""
    fc.note_entry()
    if row.device.type == "cpu":
        return dense_monoid_table_plain(row, leaves, ops, inits, nslots)
    fc._check(row, "dense_monoid_table row", (torch.int32,), 1)
    B, S = int(row.shape[0]), int(nslots)
    if not table_supported(B, S):
        raise WindFlowError(
            f"dense_monoid_table: {B} lanes / {S} slots outside the kernel "
            "gate (table_supported)")
    outs, desc = [], []
    for i, (l, op, init) in enumerate(zip(leaves, ops, inits)):
        fc._check(l, f"dense_monoid_table leaf {i}", tuple(_DTYPE_CODE),
                  l.ndim)
        if not table_leaf_ok(tuple(l.shape), l.dtype) \
                or int(l.shape[0]) != B or op not in _OP_CODE \
                or l.device != row.device:
            raise WindFlowError(
                f"dense_monoid_table: leaf {i} {tuple(l.shape)} {l.dtype} "
                f"op {op!r} outside the kernel gate (table_leaf_ok)")
        out = torch.empty((S,) + tuple(l.shape[1:]), dtype=l.dtype,
                          device=l.device)
        outs.append(out)
        W = 1 if l.ndim == 1 else int(l.shape[1])
        for c in range(W):
            desc.append((l.data_ptr(), out.data_ptr(), W, c,
                         _DTYPE_CODE[l.dtype], _OP_CODE[op],
                         _init_bits(init, l.dtype)))
    for g in range(0, len(desc), TABLE_MAX_COLS):
        group = desc[g:g + TABLE_MAX_COLS]
        ncols = len(group)
        nt = min(-(-B // TABLE_TILE), TABLE_MAX_TILES,
                 max(1, PARTIAL_WORDS // (S * ncols)))
        partial = torch.empty(ncols * nt * S, dtype=torch.int64,
                              device=row.device)
        words = (ctypes.c_longlong * (7 * ncols))(
            *[ctypes.c_longlong(w).value for d in group for w in d])
        fc._launch("dense_monoid_table", row.device, row.data_ptr(), B, S,
                   ncols, ctypes.addressof(words), partial.data_ptr(), nt)
    return outs


def routed_monoid_tables(row: torch.Tensor, payload, monoid: str,
                         nslots: int, lax_leaf, ts=None, ts_init: int = 0,
                         lax_ts=None, want_count: bool = False):
    """Per-leaf routing around :func:`dense_monoid_table` — the one front
    door of the dense and compacted reduce steps.

    Returns ``None`` when no leaf of ``payload`` passes the gates (the
    caller keeps its torch scatters), else ``(table_tree, ts_table,
    count_table)``: ``table_tree`` mirrors ``payload``, with gated-out
    leaves computed by ``lax_leaf(leaf)``; ``ts_table`` the per-slot max
    of ``ts`` from ``ts_init`` (``None`` without ``ts``); ``count_table``
    the int32 per-slot lane count (``None`` unless ``want_count``)."""
    leaves, treedef = tree_flatten(payload)
    B = int(row.shape[0])
    routed = [table_leaf_ok(tuple(l.shape), l.dtype) for l in leaves]
    # wfverify: ok (routing by the leaves' shapes and dtypes; the slot
    # gate last, so a gate that holds is a launch that follows)
    if not any(routed) or not table_supported(B, nslots):
        return None
    hot = [l.contiguous() for l, r in zip(leaves, routed) if r]
    vals = list(hot)
    ops = [monoid] * len(hot)
    inits = [fc.monoid_identity(monoid, l.dtype) for l in hot]
    if want_count:
        vals.append(torch.ones(B, dtype=torch.int32, device=row.device))
        ops.append("sum")
        inits.append(0)
    ts_rides = ts is not None and table_leaf_ok((B,), ts.dtype)
    if ts_rides:  # wfverify: ok (the ts lane's dtype decides)
        vals.append(ts.contiguous())
        ops.append("max")
        inits.append(int(ts_init))
    tabs = dense_monoid_table(row.contiguous(), vals, ops, inits, nslots)
    it = iter(tabs[:len(hot)])
    table_tree = tree_unflatten(treedef, [next(it) if r else lax_leaf(l)
                                          for l, r in zip(leaves, routed)])
    cnt = tabs[len(hot)] if want_count else None
    if ts_rides:  # wfverify: ok (the ts lane's dtype decides)
        ts_t = tabs[-1]
    else:
        ts_t = lax_ts() if (ts is not None and lax_ts is not None) else None
    return table_tree, ts_t, cnt
