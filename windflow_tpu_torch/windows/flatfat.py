"""FlatFAT: flat fixed-size aggregator tree for incremental sliding-window
aggregation (the port of ``windflow_tpu/windows/flatfat.py``; reference
``flatfat.hpp:54-``).

A segment tree over a ring buffer of ``capacity`` (power of two) leaves.
Leaves hold lifted values (or pane aggregates); internal nodes hold the
combination of their children, so any window range query costs O(log C) and a
leaf update costs O(log C) ancestor refreshes — instead of O(window) recompute
per slide.  ``None`` is the identity: empty leaves/subtrees
are skipped, so no identity element is required of the user combiner (the
reference fills gaps with default-constructed results; ``None`` is cleaner).

Positions are *logical* (monotonically growing tuple index or pane id); the
physical slot is ``pos % capacity``.  The caller is responsible for not
querying ranges wider than the capacity (windows plus in-flight slack)."""

from __future__ import annotations

from typing import Any, Callable, Optional


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class FlatFAT:
    __slots__ = ("comb", "capacity", "_tree", "_slot_pos")

    def __init__(self, comb: Callable[[Any, Any], Any], capacity: int) -> None:
        self.comb = comb
        self.capacity = next_pow2(max(2, capacity))
        # 1-based heap layout: node 1 is the root, leaves at [C, 2C).
        self._tree = [None] * (2 * self.capacity)
        # logical position currently held by each leaf slot (-1 = empty)
        self._slot_pos = [-1] * self.capacity

    def _comb2(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return self.comb(a, b)

    def update(self, pos: int, value: Any,
               fold: Optional[Callable] = None) -> None:
        """Write (or fold into) the leaf for logical position ``pos`` and
        refresh its ancestors (reference leaf insert + ``update`` path,
        ``flatfat.hpp``)."""
        slot = pos % self.capacity
        i = self.capacity + slot
        if self._slot_pos[slot] == pos and self._tree[i] is not None \
                and fold is not None:
            self._tree[i] = fold(self._tree[i], value)
        else:
            self._tree[i] = value
            self._slot_pos[slot] = pos
        i >>= 1
        while i >= 1:
            self._tree[i] = self._comb2(self._tree[2 * i],
                                        self._tree[2 * i + 1])
            i >>= 1

    def evict(self, pos: int) -> None:
        """Clear the leaf for logical position ``pos`` if it still holds it."""
        slot = pos % self.capacity
        if self._slot_pos[slot] == pos:
            self._slot_pos[slot] = -1
            i = self.capacity + slot
            self._tree[i] = None
            i >>= 1
            while i >= 1:
                self._tree[i] = self._comb2(self._tree[2 * i],
                                            self._tree[2 * i + 1])
                i >>= 1

    def holds(self, pos: int) -> bool:
        return self._slot_pos[pos % self.capacity] == pos

    def live_items(self):
        """(logical position, value) for every occupied leaf."""
        return [(p, self._tree[self.capacity + s])
                for s, p in enumerate(self._slot_pos) if p >= 0]

    def query(self, lo: int, hi: int) -> Any:
        """Combine leaves for logical positions [lo, hi).  The range must not
        exceed ``capacity`` (reference prefix/suffix query,
        ``flatfat.hpp:84-,:311-340``)."""
        if hi <= lo:
            return None
        if hi - lo > self.capacity:
            raise ValueError("query range exceeds FlatFAT capacity")
        plo = lo % self.capacity
        phi = (hi - 1) % self.capacity
        if plo <= phi:
            return self._range(plo, phi + 1)
        return self._comb2(self._range(plo, self.capacity),
                           self._range(0, phi + 1))

    def _range(self, lo: int, hi: int) -> Any:
        """Standard iterative segment-tree combine over physical [lo, hi)."""
        res_l = None
        res_r = None
        lo += self.capacity
        hi += self.capacity
        while lo < hi:
            if lo & 1:
                res_l = self._comb2(res_l, self._tree[lo])
                lo += 1
            if hi & 1:
                hi -= 1
                res_r = self._comb2(self._tree[hi], res_r)
            lo >>= 1
            hi >>= 1
        return self._comb2(res_l, res_r)
