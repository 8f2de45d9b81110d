"""DeviceSource: batches generated ON the card (the port of
``windflow_tpu/io/device_source.py``).

The reference's GPU sources materialise tuples in host memory and copy
them in (``batch_gpu_t.hpp:51-229``); here the generator itself runs on
the card, so a batch is born in device memory and the host link never
carries the hot path: synthetic and benchmark feeds, replay of
device-resident data, load generators.

Contract: ``batch_fn(i)`` is a torch function of the Python int batch
index ``i`` returning a payload pytree of tensors on the graph's device,
each with leading dimension ``capacity``; it runs eagerly, once per
tick, and must not read the device on the host.  Timestamps: INGRESS
stamps the whole batch with one monotone host arrival stamp (a
``torch.full`` on the card); EVENT requires ``ts_fn(i)`` (an int64
``[capacity]`` lane on the card) plus ``wm_fn(i) -> int``, the batch's
watermark frontier on the host, so the host never reads device lanes to
learn time.  ``ts_bounds_fn(i) -> (ts_min, ts_max)`` optionally gives
EVENT batches host-known timestamp extrema (the time-window ring sizes
itself from them).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from windflow_tpu_torch.basic import (RoutingMode, TimePolicy, WindFlowError,
                                      current_time_usecs)
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.source import BaseSourceReplica, Source
from windflow_tpu_torch.utils.tree import tree_leaves


class DeviceSourceReplica(BaseSourceReplica):
    def __init__(self, op: "DeviceSource", index: int) -> None:
        super().__init__(op, index)
        self._i = index              # replicas stride the batch index space
        self._checked = False

    def start(self) -> None:
        if self.time_policy == TimePolicy.EVENT \
                and (self.op.ts_fn is None or self.op.wm_fn is None):
            raise WindFlowError(
                f"device source '{self.op.name}': EVENT time policy needs "
                "both ts_fn (device lane) and wm_fn (host frontier)")
        if self.time_policy != TimePolicy.EVENT and self.op.ts_fn is not None:
            # event-time lanes under a wall-clock watermark would put every
            # tuple far behind the frontier: windows would drop them as late
            raise WindFlowError(
                f"device source '{self.op.name}': withTimestampFn requires "
                "the EVENT time policy (INGRESS stamps arrival time itself)")

    def _generate(self, base_ts: int):
        op = self.op
        cap, dev = op.capacity, op.device
        payload = op.batch_fn(self._i)
        if not self._checked:
            # once: the generator's lanes must be born on the graph's
            # device at the batch shape (no silent copy, no host read)
            for leaf in tree_leaves(payload):
                if not isinstance(leaf, torch.Tensor) \
                        or leaf.device.type != dev.type \
                        or leaf.shape[:1] != (cap,):
                    raise WindFlowError(
                        f"device source '{op.name}': batch_fn must return "
                        f"tensors on {dev} with leading dimension {cap}")
            self._checked = True
        if op.ts_fn is not None:
            ts = op.ts_fn(self._i).to(torch.int64)
        else:
            ts = torch.full((cap,), base_ts, dtype=torch.int64, device=dev)
        return payload, ts, torch.ones(cap, dtype=torch.bool, device=dev)

    def tick(self, max_items: int) -> bool:
        """One device batch a tick (``max_items`` is a host-tuple notion;
        a device source's quantum is its batch)."""
        if self._exhausted:
            return False
        if self._i >= self.op.n_batches:
            self._exhausted = True
            self._terminate()
            return True
        if self.time_policy == TimePolicy.INGRESS:
            base = max(current_time_usecs(), self._last_ts + 1)
            wm = base
            # every lane carries the same arrival stamp: the extrema are
            # known on the host for free
            ts_lo = ts_hi = base
        else:
            base = 0
            wm = int(self.op.wm_fn(self._i))
            if self.op.ts_bounds_fn is not None:
                lo, hi = self.op.ts_bounds_fn(self._i)
                ts_lo, ts_hi = int(lo), int(hi)
            else:
                ts_lo = ts_hi = None
        payload, ts, valid = self._generate(base)
        self._last_ts = max(self._last_ts, wm)
        self._advance_wm(self._last_ts)
        self.stats.outputs_sent += self.op.capacity
        self.stats.device_programs_launched += 1
        self.emitter.emit_device_batch(
            DeviceBatch(payload, ts, valid, watermark=self.current_wm,
                        size=self.op.capacity, ts_min=ts_lo, ts_max=ts_hi))
        self._i += self.op.parallelism
        self._count_toward_punctuation(self.op.capacity)
        return True


class DeviceSource(Source):
    """Source whose batches are generated on the card (see the module
    docstring).  ``n_batches`` bounds the stream; replica r generates
    batches r, r + parallelism, ..."""

    replica_class = DeviceSourceReplica

    def __init__(self, batch_fn: Callable, capacity: int, n_batches: int,
                 name: str = "device_source", parallelism: int = 1,
                 ts_fn: Optional[Callable] = None,
                 wm_fn: Optional[Callable[[int], int]] = None,
                 ts_bounds_fn: Optional[Callable] = None,
                 record_spec=None) -> None:
        if capacity <= 0 or n_batches < 0:
            raise WindFlowError(
                "device source needs capacity > 0 and n_batches >= 0")
        Operator.__init__(self, name, parallelism, routing=RoutingMode.NONE,
                          output_batch_size=capacity, is_gpu=True)
        self.batch_fn = batch_fn
        self.capacity = capacity
        self.n_batches = n_batches
        self.ts_fn = ts_fn
        self.wm_fn = wm_fn
        self.ts_bounds_fn = ts_bounds_fn
        self.ts_extractor = None
        self.record_spec = record_spec
