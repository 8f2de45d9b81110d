"""The host key probe of the shard plane (the port of ``HostKeyProbe``,
``windflow_tpu/monitoring/shard_ledger.py:470-530``; its keys come from
``parallel/emitters.host_keys``, which wraps them to int32 as
``_key32_np`` does).

A plain (non-keyed) staging emitter feeding a keyed device consumer
whose key extraction runs in its step already holds the batch's fields
on the host, so the consumer's key extractor can run there, a batch at
a time.  The port keeps the compactor half: the probe is the admission
point of a host-fed compacted consumer (``parallel/compaction.py``),
which then sees a miss-free remap.  The shard sketch it also feeds in
the JAX package is ROADMAP A8: ``sketch`` is kept and always ``None``.
Any extractor failure disables the probe for good and deactivates the
compactor, so the consumer falls back to its own path instead of
starving its table.
"""

from __future__ import annotations


class HostKeyProbe:
    """Key probe on a plain staging emitter: ``columns`` on the columnar
    path, ``items`` on the record path (its open batch, stacked to
    columns, before it ships)."""

    __slots__ = ("sketch", "key_fn", "dead", "compactor")

    def __init__(self, sketch, key_fn, compactor=None) -> None:
        self.sketch = sketch
        self.key_fn = key_fn
        self.compactor = compactor
        self.dead = False

    def _fail(self) -> None:
        self.dead = True
        if self.compactor is not None:
            self.compactor.deactivate()

    def columns(self, cols, n: int) -> None:
        if self.dead or n == 0:
            return
        from windflow_tpu_torch.parallel.emitters import host_keys
        try:
            k32 = host_keys(self.key_fn, cols, n)
            if self.compactor is not None:
                self.compactor.observe(k32)
        except Exception:  # noqa: BLE001 -- any failure means the probe
            # cannot see; the staging path must go on
            self._fail()

    def items(self, items) -> None:
        if self.dead or not items:
            return
        from windflow_tpu_torch.batch import _stack_records
        try:
            cols = _stack_records(items)
        except Exception:  # noqa: BLE001 -- records that do not stack
            self._fail()
            return
        self.columns(cols, len(items))
