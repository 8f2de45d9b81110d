"""Ffat_Windows: incremental sliding/tumbling window aggregation over a
lift/combine pair, powered by per-key FlatFAT trees on the host (the port
of ``windflow_tpu/windows/ffat_op.py``; reference ``ffat_windows.hpp:63``,
replica ``ffat_replica.hpp:59``).  Its device counterpart is
``windows/ffat_gpu.py``.

* CB windows: one leaf per tuple (lifted); window [w*slide, w*slide+win)
  queried over tuple indices.
* TB windows: leaves are *quantum panes* of length gcd(win, slide) µs — the
  reference's TB path uses the same quantization (``ffat_replica.hpp`` TB
  quantum panes).  Tuples fold into their pane leaf; firing is gated by the
  watermark (+lateness) in DEFAULT mode and by the timestamp frontier in the
  ordered modes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

from windflow_tpu_torch.basic import (EMPTY_KEY, ExecutionMode,
                                      RoutingMode, WindFlowError, WinType)
from windflow_tpu_torch.batch import WM_NONE
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.windows.engine import WindowSpec
from windflow_tpu_torch.windows.flatfat import FlatFAT, next_pow2
from windflow_tpu_torch.windows.ops import WindowResult


class _FfatKeyState:
    __slots__ = ("fat", "next_pos", "next_win", "max_ts", "started")

    def __init__(self, fat: FlatFAT):
        self.fat = fat
        self.next_pos = 0       # CB: next tuple index; TB: unused
        self.next_win = None    # next gwid to fire (None until first tuple)
        self.max_ts = 0
        self.started = False


class FfatWindowsReplica(Replica):
    def __init__(self, op: "FfatWindows", index: int) -> None:
        super().__init__(op, index)
        self._keys: Dict[Any, _FfatKeyState] = {}
        spec = op.spec
        if spec.win_type == WinType.CB:
            self._domain_win = spec.win_len
            self._domain_slide = spec.slide
            self._quantum = 1
        else:
            # TB: operate in the pane domain (quantum = gcd(win, slide) µs)
            self._quantum = math.gcd(spec.win_len, spec.slide)
            self._domain_win = spec.win_len // self._quantum
            self._domain_slide = spec.slide // self._quantum
        # ring must hold every pane of any unfired window, plus lateness slack
        slack = (op.lateness // self._quantum + 1
                 if op.spec.win_type == WinType.TB else 2)
        self._cap = next_pow2(self._domain_win + self._domain_slide + slack)

    # -- helpers -------------------------------------------------------------
    def _state(self, key) -> _FfatKeyState:
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _FfatKeyState(
                FlatFAT(self.op.comb, self._cap))
        return st

    def _win_start(self, w: int) -> int:
        return w * self._domain_slide

    def _win_end(self, w: int) -> int:
        return w * self._domain_slide + self._domain_win

    def _first_window_of(self, d: int) -> int:
        return max(0, -(-(d - self._domain_win + 1) // self._domain_slide))

    # -- ingestion -----------------------------------------------------------
    def process_single(self, item, ts, wm):
        op = self.op
        key = op.key_of(item)
        st = self._state(key)
        lifted = op.lift(item)
        if op.spec.win_type == WinType.CB:
            pos = st.next_pos
            st.next_pos += 1
            if not st.started:
                st.started = True
                st.next_win = 0
            st.fat.update(pos, lifted)
            st.max_ts = max(st.max_ts, ts)
            # fire every window completed by this tuple
            while self._win_end(st.next_win) <= st.next_pos:
                self._fire(key, st, st.next_win)
                st.next_win += 1
        else:
            pane = ts // self._quantum
            if self._domain_slide > self._domain_win \
                    and pane % self._domain_slide >= self._domain_win:
                # hopping windows with gaps (slide > win): panes in the
                # inter-window gap belong to NO window — never write them
                # into the ring (they would linger unevicted and fold into
                # whatever pane wraps onto their slot; the device step
                # masks these lanes the same way, ffat_kernels.py)
                return
            if not st.started:
                st.started = True
                st.next_win = self._first_window_of(pane)
            if st.next_win is not None \
                    and pane < self._win_start(st.next_win):
                self.stats.inputs_ignored += 1   # late beyond fired windows
                return
            # grow the ring if the watermark lag has widened the live span
            # beyond capacity (unfired windows pin old panes while new panes
            # keep arriving)
            span = pane - self._win_start(st.next_win) + self._domain_win
            if span >= st.fat.capacity:
                old = st.fat
                st.fat = FlatFAT(op.comb, next_pow2(span + 2))
                for p, v in old.live_items():
                    st.fat.update(p, v)
            st.fat.update(pane, lifted, fold=op.comb)
            st.max_ts = max(st.max_ts, ts)
            if self.mode != ExecutionMode.DEFAULT:
                # ordered input: fire windows ending at or before this
                # timestamp — equal timestamps may still arrive (legal ties),
                # so a window ending at ts+1 must NOT fire yet
                self._fire_tb(key, st, ts)

    def on_watermark(self, wm):
        if self.op.spec.win_type != WinType.TB or wm == WM_NONE \
                or self.mode != ExecutionMode.DEFAULT:
            return
        limit = wm - self.op.lateness
        # global window-end order across keys keeps output watermarks
        # monotone (see WindowEngine.on_watermark)
        ready = []
        for key, st in self._keys.items():
            if not st.started:
                continue
            w = st.next_win
            while self._win_end(w) * self._quantum <= limit:
                ready.append((self._win_end(w), key, w))
                w += 1
        ready.sort()
        for _, key, w in ready:
            st = self._keys[key]
            self._fire(key, st, w)
            st.next_win = w + 1

    def _fire_tb(self, key, st: _FfatKeyState, time_limit: int) -> None:
        # fire windows whose end time <= time_limit (ordered-mode eager path)
        while self._win_end(st.next_win) * self._quantum <= time_limit:
            self._fire(key, st, st.next_win)
            st.next_win += 1

    def _fire(self, key, st: _FfatKeyState, gwid: int,
              partial_end: Optional[int] = None) -> None:
        lo = self._win_start(gwid)
        hi = partial_end if partial_end is not None else self._win_end(gwid)
        value = st.fat.query(lo, hi)
        if value is not None:
            # windows are only materialized by the tuples they contain; empty
            # time windows emit nothing (reference: windows open on arrival)
            if self.op.spec.win_type == WinType.TB:
                ts = self._win_end(gwid) * self._quantum - 1
            else:
                ts = st.max_ts
            self.stats.outputs_sent += 1
            wm = ts if self.current_wm == WM_NONE \
                else min(self.current_wm, ts)
            self.emitter.emit(WindowResult(key, gwid, value), ts, wm)
        # evict leaves no longer needed by any future window
        next_lo = self._win_start(gwid + 1)
        for pos in range(lo, min(hi, next_lo)):
            st.fat.evict(pos)

    def on_eos(self):
        # flush remaining windows that have content (reference EOS flush)
        for key, st in self._keys.items():
            if not st.started:
                continue
            if self.op.spec.win_type == WinType.CB:
                last = st.next_pos  # exclusive
                while self._win_start(st.next_win) < last:
                    self._fire(key, st, st.next_win,
                               partial_end=min(self._win_end(st.next_win),
                                               last))
                    st.next_win += 1
            else:
                last_pane = st.max_ts // self._quantum + 1
                while self._win_start(st.next_win) < last_pane:
                    self._fire(key, st, st.next_win,
                               partial_end=min(self._win_end(st.next_win),
                                               last_pane))
                    st.next_win += 1


class FfatWindows(Operator):
    """Keyed FlatFAT windows (reference ``Ffat_Windows``): KEYBY routing like
    Keyed_Windows, incremental lift/combine logic."""

    replica_class = FfatWindowsReplica
    # host FlatFAT trees are not snapshot-capable yet (WF603)
    checkpoint_opaque = True

    def __init__(self, lift: Callable[[Any], Any],
                 comb: Callable[[Any, Any], Any], spec: WindowSpec, *,
                 name: str = "ffat_windows", parallelism: int = 1,
                 key_extractor: Optional[Callable] = None,
                 lateness: int = 0, output_batch_size: int = 0) -> None:
        routing = (RoutingMode.KEYBY if key_extractor is not None
                   else RoutingMode.FORWARD)
        if key_extractor is None and parallelism > 1:
            raise WindFlowError(
                "Ffat_Windows with parallelism > 1 requires a key extractor")
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.lift = lift
        self.comb = comb
        if lateness:
            spec = dataclasses.replace(spec, lateness=lateness)
        self.spec = spec

    @property
    def lateness(self) -> int:
        # single source of truth: the WindowSpec
        return self.spec.lateness

    def key_of(self, item):
        if self.key_extractor is None:
            return EMPTY_KEY
        return self.key_extractor(item)
