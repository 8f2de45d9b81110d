"""The window engine: per-key window bookkeeping shared by every host
window operator (the port of ``windflow_tpu/windows/engine.py``).

Re-design of the reference's single window engine ``Window_Replica``
(``window_replica.hpp:61-419``), which powers Keyed/Parallel/Paned/
MapReduce windows through per-key ``Key_Descriptor`` structs (archive,
open windows, next lwid), an lwid→gwid mapping for round-robin window
assignment, incremental vs non-incremental user logic, a lateness gate
in DEFAULT mode, and EOS flushing.  The same roles exist here
(``basic.hpp:219``): SEQ, PLQ, WLQ, MAP, REDUCE.

Windows are defined over a *domain*: a monotone integer per tuple per key
— the per-key arrival index for count-based windows, the timestamp for
time-based ones, and an explicit id (pane gwid) for the WLQ stage of
paned windows.  Window ``w`` covers domain values ``[w*slide, w*slide +
win_len)``.  ``WindowSpec`` is shared with the device windows
(``windows/ffat_gpu.py``).

Firing:
* count/id domains fire eagerly when the domain frontier passes a
  window's end;
* time domains in DEFAULT mode are gated by the watermark plus the
  user-configured lateness (``window_replica.hpp:305``), across all keys
  in global window-end order; tuples whose every window has already
  fired are counted as ignored (reference ``inputs_ignored``); in
  DETERMINISTIC/PROBABILISTIC modes inputs arrive (re)ordered, so time
  windows also fire eagerly from the domain frontier;
* EOS flushes every open window (``window_replica.hpp:356-408``).

The engine is pure Python and touches no tensor: it runs on the host in
both packages, whatever device the graph runs on.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, List, Optional

from windflow_tpu_torch.basic import ExecutionMode, WindowRole, WinType
from windflow_tpu_torch.batch import WM_NONE


@dataclasses.dataclass
class WindowSpec:
    win_type: WinType          # CB (count) or TB (time, microseconds)
    win_len: int
    slide: int
    lateness: int = 0          # TB + DEFAULT mode only (usec)

    def first_window_of(self, d: int) -> int:
        # smallest w with w*slide + win_len > d
        return max(0, -(-(d - self.win_len + 1) // self.slide))

    def last_window_of(self, d: int) -> int:
        return d // self.slide

    def window_end(self, w: int) -> int:
        return w * self.slide + self.win_len


class Archive:
    """Ordered store of ``(domain, arrival_id, item, ts)`` entries for
    non-incremental window logic (reference ``StreamArchive``,
    ``stream_archive.hpp:48-146``).  The default keeps everything in memory;
    the persistent suite substitutes a spilling variant
    (``persistent/p_windows.py``) whose overflow lives in the KV store,
    mirroring the reference's RocksDB window fragments
    (``p_window_replica.hpp:90-176``)."""

    __slots__ = ("_entries",)

    def __init__(self) -> None:
        self._entries: List = []

    def insert(self, entry) -> None:
        if self._entries and self._entries[-1][:2] > entry[:2]:
            bisect.insort(self._entries, entry)
        else:
            self._entries.append(entry)

    def range(self, start: int, end: int) -> List:
        """Entries with ``start <= domain < end``, in (domain, aid) order."""
        lo = bisect.bisect_left(self._entries, (start, -1))
        hi = bisect.bisect_left(self._entries, (end, -1))
        return self._entries[lo:hi]

    def purge_below(self, d: int) -> None:
        lo = bisect.bisect_left(self._entries, (d, -1))
        if lo > 0:
            del self._entries[:lo]

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


class _OpenWindow:
    __slots__ = ("gwid", "acc", "count", "max_ts")

    def __init__(self, gwid: int):
        self.gwid = gwid
        self.acc = None     # incremental accumulator
        self.count = 0      # tuples folded in
        self.max_ts = 0


class _KeyDescriptor:
    """Reference ``Key_Descriptor`` (``window_replica.hpp:84-105``)."""

    __slots__ = ("next_id", "archive", "open", "next_unfired", "frontier",
                 "fired_ahead")

    def __init__(self, archive: Archive):
        self.next_id = 0                    # per-key arrival counter
        self.archive = archive              # (domain, aid, item, ts) entries
        self.open: Dict[int, _OpenWindow] = {}
        self.next_unfired = 0               # lowest gwid not yet fired
        self.frontier = WM_NONE             # max domain value seen
        self.fired_ahead: set = set()       # gwids fired out of order


class WindowEngine:
    """One engine instance per window-operator replica.

    ``emit(key, gwid, ts, value)`` is called for every fired window."""

    def __init__(self, spec: WindowSpec, fn: Callable, incremental: bool,
                 role: WindowRole, parallelism: int, replica_index: int,
                 mode: ExecutionMode,
                 emit: Callable[[Any, int, int, Any], None],
                 domain_fn: Optional[Callable] = None,
                 wm_to_domain: Optional[Callable[[int], int]] = None,
                 count_complete: bool = False,
                 stats=None,
                 archive_factory: Callable[[Any], Archive] = None) -> None:
        self.spec = spec
        self.fn = fn
        self.incremental = incremental
        self.role = role
        self.parallelism = parallelism
        self.replica_index = replica_index
        self.mode = mode
        self.emit = emit
        self.domain_fn = domain_fn          # id-domain extractor (WLQ)
        # maps a time watermark into the id domain (WLQ over time panes:
        # pane p is complete once wm >= (p+1)*pane_len)
        self.wm_to_domain = wm_to_domain
        # fire a window the moment it holds win_len contributions (WLQ over
        # count panes, where pane results may arrive out of order across the
        # upstream pane replicas)
        self.count_complete = count_complete
        self.stats = stats
        self.archive_factory = archive_factory or (lambda key: Archive())
        self.keys: Dict[Any, _KeyDescriptor] = {}
        self._eager = ((spec.win_type == WinType.CB
                        or mode != ExecutionMode.DEFAULT)
                       and domain_fn is None) and not count_complete

    # -- ingestion -----------------------------------------------------------
    def on_tuple(self, key: Any, item: Any, ts: int, wm: int) -> None:
        kd = self.keys.get(key)
        if kd is None:
            kd = self.keys[key] = _KeyDescriptor(self.archive_factory(key))
        aid = kd.next_id
        kd.next_id += 1
        d = self._domain_of(aid, item, ts)
        hi = self.spec.last_window_of(d)
        if hi < kd.next_unfired:
            # every window this tuple belongs to has already fired
            if self.stats is not None:
                self.stats.inputs_ignored += 1
            return
        lo = max(self.spec.first_window_of(d), kd.next_unfired)
        kd.frontier = max(kd.frontier, d)
        if not self.incremental:
            # archive ordered by (domain, arrival id) — reference
            # StreamArchive binary-search insert (stream_archive.hpp:48-146)
            kd.archive.insert((d, aid, item, ts))
        keep = self._keeps_tuple(aid)
        for w in range(lo, hi + 1):
            if not self._owns_window(w) or w in kd.fired_ahead:
                continue
            ow = kd.open.get(w)
            if ow is None:
                ow = kd.open[w] = _OpenWindow(w)
            ow.max_ts = max(ow.max_ts, ts)
            if keep:
                if self.incremental:
                    ow.acc = self.fn(item, ow.acc)
                ow.count += 1
            if self.count_complete and ow.count >= self.spec.win_len:
                self._fire(key, kd, w)
        if self._eager:
            # A window is complete once the frontier reaches its end.  Count
            # domains are dense per key, so id w*slide+win_len-1 completes
            # the window (limit = frontier+1); time domains allow ties, so a
            # window only completes once a strictly-later timestamp arrives
            # (limit = frontier).
            bump = 1 if self.spec.win_type == WinType.CB else 0
            self._fire_upto(key, kd, kd.frontier + bump)

    def on_watermark(self, wm: int) -> None:
        if self._eager or self.count_complete or wm == WM_NONE:
            return
        limit = wm - self.spec.lateness
        if self.wm_to_domain is not None:
            limit = self.wm_to_domain(limit)
        # Fire across ALL keys in global window-end order, so the watermarks
        # stamped on emitted results (their result ts) are monotone per
        # output channel — an out-of-order emission would over-promise the
        # downstream watermark frontier and make downstream time windows fire
        # before sibling results arrive.
        ready = sorted(
            ((self.spec.window_end(w), key, w)
             for key, kd in self.keys.items() for w in kd.open
             if self.spec.window_end(w) <= limit))
        for _, key, w in ready:
            self._fire(key, self.keys[key], w)

    def on_eos(self) -> None:
        for key in list(self.keys):
            kd = self.keys[key]
            self._fire_upto(key, kd, None)
            kd.archive.clear()

    # -- internals -----------------------------------------------------------
    def _domain_of(self, aid: int, item: Any, ts: int) -> int:
        if self.domain_fn is not None:
            return self.domain_fn(item)
        if self.spec.win_type == WinType.CB:
            return aid
        return ts

    def _owns_window(self, gwid: int) -> bool:
        """Round-robin window assignment for parallel window stages
        (reference lwid→gwid arithmetic, ``window_replica.hpp:253-276``)."""
        if self.role in (WindowRole.PLQ, WindowRole.WLQ) \
                and self.parallelism > 1:
            return gwid % self.parallelism == self.replica_index
        return True

    def _keeps_tuple(self, aid: int) -> bool:
        """MAP-role partitioning: each replica folds only its share of every
        window's tuples (reference MAP discard rule,
        ``window_replica.hpp:286-288``)."""
        if self.role == WindowRole.MAP and self.parallelism > 1:
            return aid % self.parallelism == self.replica_index
        return True

    def _fire_upto(self, key: Any, kd: _KeyDescriptor,
                   limit: Optional[int]) -> None:
        """Fire open windows with end <= ``limit`` (None = EOS: fire all)."""
        ready = sorted(w for w in kd.open
                       if limit is None or self.spec.window_end(w) <= limit)
        for w in ready:
            self._fire(key, kd, w)

    def _fire(self, key: Any, kd: _KeyDescriptor, gwid: int) -> None:
        ow = kd.open.pop(gwid)
        start = gwid * self.spec.slide
        end = self.spec.window_end(gwid)
        if self.incremental:
            value = ow.acc
        else:
            items = [e[2] for e in kd.archive.range(start, end)
                     if self._keeps_tuple(e[1])]
            value = self.fn(items)
        # advance the fired frontier, tolerating out-of-order completions
        # (count-complete mode can finish window w+1 before w)
        kd.fired_ahead.add(gwid)
        while kd.next_unfired in kd.fired_ahead:
            kd.fired_ahead.discard(kd.next_unfired)
            kd.next_unfired += 1
        self._purge(kd)
        ts = end - 1 if (self.spec.win_type == WinType.TB
                         and self.domain_fn is None) else ow.max_ts
        self.emit(key, gwid, ts, value)

    def _purge(self, kd: _KeyDescriptor) -> None:
        """Drop archived tuples no longer covered by any unfired window
        (reference ``StreamArchive::purge``)."""
        if self.incremental or not len(kd.archive):
            return
        kd.archive.purge_below(kd.next_unfired * self.spec.slide)
