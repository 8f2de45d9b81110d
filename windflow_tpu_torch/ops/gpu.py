"""Device operators: the port of ``MapTPU``/``FilterTPU``
(``windflow_tpu/ops/tpu.py:113-183``) under the reference's own names,
``MapGPU`` and ``FilterGPU`` (reference ``map_gpu.hpp``,
``filter_gpu.hpp``).

* ``MapGPU`` applies the per-record function to the batch's column dict
  (``utils.tree.per_record``), one elementwise pass over every lane.
* ``FilterGPU`` intersects the validity mask with the predicate and never
  compacts: downstream operators and the device→host boundary are
  mask-aware.

Both run in DEFAULT mode only and need an upstream output batch size > 0,
as in the reference.

``_GPUReplica.process_device_batch`` is the one step site of every device
operator (map, filter, chained, reduce, stateful, windows, fused hops):
its first step runs under the capture audit's recorder
(``analysis/ir_audit.record_step``); it counts the dispatch in the step
registry and, on a traced batch,
stamps ``dispatched``, wraps the step in ``record_function("op:<name>
trace:<id>")`` for a ``torch.profiler`` capture, and on every
``trace_device_sync_every``-th traced batch waits for the step's device
work to stamp ``device_done``.
"""

from __future__ import annotations

from typing import Callable

from windflow_tpu_torch.basic import RoutingMode, current_time_usecs
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.monitoring import recorder as flightrec
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.utils.tree import per_record, tree_map


class _GPUReplica(Replica):
    """Shared device-batch plumbing for device operator replicas."""

    def __init__(self, op, index: int) -> None:
        super().__init__(op, index)
        # the capture audit rides the first step (analysis/ir_audit.py):
        # this instance attribute shadows _op_step once, then goes
        self._op_step = self._first_step

    def _first_step(self, batch: DeviceBatch):
        del self._op_step
        from windflow_tpu_torch.analysis import ir_audit
        if not ir_audit.enabled(self.config):
            return self._op_step(batch)
        return ir_audit.record_step(self, batch)

    def _op_step(self, batch: DeviceBatch):
        fx = self.op._fusion_exec
        if fx is not None:
            # the last member of an all-stateless fused segment runs the
            # whole chain (fusion/executor.py)
            return fx.step(batch)
        return self.op._step(batch)

    def process_device_batch(self, batch: DeviceBatch) -> None:
        tr = batch.trace
        if tr is not None:
            # profiler bridge: a torch.profiler capture (PipeGraph.profile)
            # lines up with dump_trace()'s spans by trace id
            from torch.autograd.profiler import record_function
            with record_function(f"op:{self.op.name} trace:{tr[0]}"):
                out = self._op_step(batch)
        else:
            out = self._op_step(batch)
        fx = self.op._fusion_exec
        (self.op if fx is None else fx).watch.note_step(batch, out, self.op)
        self.stats.device_programs_launched += 1
        if self.ring is not None and tr is not None:
            # `dispatched` stamps the enqueue; the device work's end is
            # seen only by waiting for it, on every M-th traced batch
            self.ring.record(tr[0], flightrec.DISPATCHED,
                             current_time_usecs())
            self._traced_seen += 1
            every = self.config.trace_device_sync_every
            if out is not None and every \
                    and self._traced_seen % every == 0:
                wait_for_device(out.valid)
                now = current_time_usecs()
                self.ring.record(tr[0], flightrec.DEVICE_DONE, now)
                if self.latency is not None:
                    # the window-freshness gauge, on this batch only: its
                    # device work is done, so the read waits for nothing
                    self.latency.note_window_fire(self.op.name, out.ts,
                                                  out.valid, now)
        if out is not None:
            if out.trace is None:
                # steps build fresh batches: the lane is relayed here
                out.trace = tr
            self.stats.outputs_sent += out.known_size or 0
            self.emitter.emit_device_batch(out)


def wait_for_device(t) -> None:
    """Wait until the work queued so far on ``t``'s stream is done: a
    CUDA event recorded now, then synchronized (the flight recorder's
    sampled ``device_done``; a CPU tensor is ready already)."""
    if t.device.type == "cuda":
        import torch
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()  # wfverify: ok (the sampled device_done wait)


class MapGPU(Operator):
    """Stateless elementwise transform on the device.  ``fn`` maps one
    record to one record; with ``batch_fn=True`` it receives the whole
    column dict and the validity mask instead."""

    replica_class = _GPUReplica

    def __init__(self, fn: Callable, name: str = "map_gpu",
                 parallelism: int = 1, batch_fn: bool = False,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        self.fn = fn
        self.batch_fn = batch_fn

    def apply(self, payload, valid):
        """The record transform over one batch: ``(payload, valid)``."""
        if self.batch_fn:
            # its own containers: the payload may be shared by a fan-out
            return self.fn(tree_map(lambda a: a, payload), valid), valid
        return per_record(self.fn, payload, valid.shape[0]), valid

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        out_payload, _ = self.apply(batch.payload, batch.valid)
        return DeviceBatch(out_payload, batch.ts, batch.valid,
                           watermark=batch.watermark, size=batch._size,
                           frontier=batch.frontier, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)


class FilterGPU(Operator):
    """Device predicate filter: survivors are a validity-mask
    intersection, never a compaction."""

    replica_class = _GPUReplica

    def __init__(self, fn: Callable, name: str = "filter_gpu",
                 parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        self.fn = fn

    def apply(self, payload, valid):
        keep = per_record(self.fn, payload, valid.shape[0])
        return payload, valid & keep.to(valid.dtype)

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        _, new_valid = self.apply(batch.payload, batch.valid)
        # survivor count unknown until read; the ts extrema stay outer
        # bounds of the surviving lanes
        return DeviceBatch(batch.payload, batch.ts, new_valid,
                           watermark=batch.watermark, frontier=batch.frontier,
                           size=None, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)
