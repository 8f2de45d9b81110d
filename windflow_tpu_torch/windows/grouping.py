"""Stable O(n) dense-key grouping permutations (the port of
``windflow_tpu/windows/grouping.py``).

The FFAT steps group a batch by key before folding runs; the reference
pays ``thrust::sort_by_key`` for it.  Keys are dense ints in ``[0, K)``,
so a stable counting sort does the job:

1. a lane's rank within its ``CHUNK``-lane chunk among equal ids is
   ``CHUNK - 1`` shifted equality compares;
2. per-chunk bucket histograms, exclusive-scanned across chunks, give
   each lane its cross-chunk offset, and across buckets each bucket's
   start;
3. ``dest = bucket_start[id] + cross_chunk[chunk, id] + within`` is a
   permutation — one scatter of iota inverts it into gather indices.

The permutation equals ``argsort(ids, stable=True)``: both order by
(id, arrival).  On the card the FFAT step reaches the hand-written
grouping kernel instead (``kernels/ffat_cuda.py``); this composition is
the path with ``Config.cuda_kernels="0"``.
"""

from __future__ import annotations

import torch

#: within-chunk width (see the module docstring)
CHUNK = 32
#: radix base: buckets per counting pass
DIGIT = 256


def dense_rank(ids: torch.Tensor, nbuckets: int):
    """Per-lane rank among equal ids in arrival order, plus bucket counts.

    Returns ``(rank, counts, idsp, pos)``: ``rank``, ``idsp`` and ``pos``
    are chunk-padded to ``Bp >= B`` (padding lanes count in a bucket of
    their own past the real ones); callers slice ``[:B]``.  All int32."""
    B = ids.shape[0]
    dev = ids.device
    C = CHUNK
    Bp = ((B + C - 1) // C) * C
    nb = nbuckets + 1
    idsp = ids.to(torch.int32)
    if Bp != B:
        idsp = torch.cat([idsp, torch.full((Bp - B,), nbuckets,
                                           dtype=torch.int32, device=dev)])
    NB = Bp // C
    pos = torch.arange(Bp, dtype=torch.int32, device=dev)
    lane = pos % C

    # 1. within-chunk rank among equal ids (arrival order)
    within = torch.zeros(Bp, dtype=torch.int32, device=dev)
    for d in range(1, C):
        shifted = torch.cat([torch.zeros(d, dtype=torch.int32, device=dev),
                             idsp[:Bp - d]])
        within += ((idsp == shifted) & (lane >= d)).to(torch.int32)

    # 2. per-chunk histograms + exclusive scan across chunks
    flat = ((pos // C) * nb + idsp).long()
    hist = torch.zeros(NB * nb, dtype=torch.int32, device=dev)
    hist.index_add_(0, flat, torch.ones(Bp, dtype=torch.int32, device=dev))
    hist = hist.reshape(NB, nb)
    cross = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    counts = hist.sum(0, dtype=torch.int32)
    rank = within + cross.reshape(-1)[flat]
    return rank, counts[:nbuckets], idsp, pos


def _single_digit_order_counts(ids: torch.Tensor, nbuckets: int):
    """Stable counting-sort permutation for ids in ``[0, nbuckets)`` plus
    the ``[nbuckets]`` histogram (the ``dense_rank`` byproduct)."""
    B = ids.shape[0]
    rank, counts, idsp, pos = dense_rank(ids, nbuckets)
    Bp = pos.shape[0]
    # padding lanes sit in the bucket after every real one, so they take
    # the tail of the permutation and ``order[:B]`` holds the real lanes
    allc = torch.cat([counts, torch.full((1,), Bp - B, dtype=torch.int32,
                                         device=ids.device)])
    start = torch.cumsum(allc, 0, dtype=torch.int32) - allc
    dest = start[idsp.long()] + rank
    order = invert_perm(dest)
    return order[:B], counts


def invert_perm(order: torch.Tensor) -> torch.Tensor:
    """Invert a permutation in O(n): ``inv[order[i]] = i``."""
    n = order.shape[0]
    inv = torch.empty(n, dtype=order.dtype, device=order.device)
    inv[order.long()] = torch.arange(n, dtype=order.dtype,
                                     device=order.device)
    return inv


def auto_order(ids: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """Stable grouping permutation: the counting permutation up to two
    radix passes, the stable sort beyond (bit-identical either way)."""
    if nbuckets <= DIGIT * DIGIT:
        return counting_order(ids, nbuckets)
    return torch.sort(ids, stable=True).indices.to(torch.int32)


def order_and_hist(ids: torch.Tensor, nbuckets: int):
    """``auto_order`` plus the ``[nbuckets]`` int32 histogram of ids."""
    if nbuckets <= DIGIT + 1:
        return _single_digit_order_counts(ids, nbuckets)
    order = auto_order(ids, nbuckets)
    hist = torch.zeros(nbuckets, dtype=torch.int32, device=ids.device)
    hist.index_add_(0, ids.long(), torch.ones_like(ids, dtype=torch.int32))
    return order, hist


def counting_order(ids: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """Stable grouping permutation over dense int ids in
    ``[0, nbuckets)``: one counting pass up to ``DIGIT + 1`` buckets, LSD
    radix over base-``DIGIT`` digits beyond."""
    if nbuckets <= DIGIT + 1:
        return _single_digit_order_counts(ids, nbuckets)[0]
    ids = ids.to(torch.int32)
    order = None
    div = 1
    span = nbuckets
    while span > 1:
        cur = ids if order is None else ids[order.long()]
        o = _single_digit_order_counts((cur // div) % DIGIT, DIGIT)[0]
        order = o if order is None else order[o.long()]
        div *= DIGIT
        span = -(-span // DIGIT)
    return order
