"""FfatWindowsGPU: incremental count-based sliding windows on the card
(the CB path of ``windflow_tpu/windows/ffat_tpu.py``; reference
``Ffat_Windows_GPU``, ``ffat_replica_gpu.hpp:424``).

Count-based windows of length W sliding by S decompose into panes of
P = gcd(W, S): R = W/P panes per window, fired every D = S/P panes.
Per-key state is dense over a static key space ``[0, max_keys)``: a carry
of the trailing R-1 pane aggregates per key plus the current partial pane
(``ffat_kernels.make_ffat_state``).  One step processes one
fixed-capacity batch and emits every window it completes, across all
keys, as one compacted output batch.

Time-based windows, ring regrowth, key compaction and the mesh path are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from windflow_tpu_torch.basic import RoutingMode, WindFlowError, WinType
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.gpu import _GPUReplica
from windflow_tpu_torch.windows.engine import WindowSpec
from windflow_tpu_torch.windows.ffat_kernels import (agg_spec_for,
                                                     make_ffat_flush,
                                                     make_ffat_state,
                                                     make_ffat_step,
                                                     resolve_monoid)


class FfatGPUReplica(_GPUReplica):
    def on_eos(self):
        # CB state is operator-level; only the LAST replica to terminate
        # may flush it
        self.op._eos_replicas += 1
        if self.op._eos_replicas < self.op.parallelism:
            return
        for out in self.op._flush():
            self.stats.device_programs_launched += 1
            self.stats.outputs_sent += out.size
            self.emitter.emit_device_batch(out)


class FfatWindowsGPU(Operator):
    replica_class = FfatGPUReplica

    def __init__(self, lift: Callable, comb: Callable, spec: WindowSpec, *,
                 max_keys: int, name: str = "ffat_windows_gpu",
                 parallelism: int = 1,
                 key_extractor: Optional[Callable] = None,
                 monoid: Optional[str] = None) -> None:
        routing = (RoutingMode.KEYBY if key_extractor is not None
                   else RoutingMode.FORWARD)
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        if spec.win_type != WinType.CB:
            raise WindFlowError(
                f"FfatWindowsGPU '{name}': time-based windows are not "
                "ported yet (count-based only)")
        if max_keys is None or max_keys < 1:
            raise WindFlowError(
                f"FfatWindowsGPU '{name}': withMaxKeys(n >= 1) is required")
        self.lift = lift
        self.comb = comb
        self.spec = spec
        self.max_keys = max_keys
        self.P = math.gcd(spec.win_len, spec.slide)
        self.R = spec.win_len // self.P
        self.D = spec.slide // self.P
        try:
            self.monoid = resolve_monoid(monoid)
        except ValueError as e:
            raise WindFlowError(str(e)) from None
        self._state = None
        self._step_fn = None
        self._capacity = None
        self._flushed = False
        self._eos_replicas = 0

    def _build_step(self, capacity: int):
        # the kernel switch resolves once per step build
        return make_ffat_step(capacity, self.max_keys, self.P, self.R,
                              self.D, self.lift, self.comb,
                              self.key_extractor, monoid=self.monoid,
                              kernels=resolve_kernels(self.config))

    def _ensure(self, batch: DeviceBatch) -> None:
        if self._capacity is None:
            self._capacity = batch.capacity
            self._step_fn = self._build_step(batch.capacity)
        elif batch.capacity != self._capacity:
            raise WindFlowError(
                "FfatWindowsGPU requires a fixed upstream batch capacity "
                f"({self._capacity}), got {batch.capacity}")
        if self._state is None:
            self._state = make_ffat_state(
                agg_spec_for(self.lift, batch.payload), self.max_keys,
                self.R, device=batch.valid.device)

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        self._ensure(batch)
        self._state, out, fired, out_ts = self._step_fn(
            self._state, batch.payload, batch.ts, batch.valid)
        return DeviceBatch(out, out_ts, fired, watermark=batch.watermark,
                           size=None)

    def _flush(self) -> list:
        """EOS flush of the shared state: fire the remaining partial
        windows (reference EOS flush of open windows)."""
        if self._state is None or self._flushed:
            return []
        self._flushed = True
        out, fired, ts = make_ffat_flush(self.max_keys, self.P, self.R,
                                         self.D, self.comb)(self._state)
        return [DeviceBatch(out, ts, fired, watermark=0, size=None)]
