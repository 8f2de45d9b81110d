"""Staging plane: host-buffer recycling pool + streaming packed batches.

The port of ``windflow_tpu/staging.py``:

* :class:`StagingPool` — size-keyed pool of host ``uint32`` staging
  buffers reused across batches.  For a CUDA target the buffers are
  PINNED host memory, so the one copy per batch runs as an asynchronous
  ``cudaMemcpyAsync``.  A released buffer carries a *gate*: the CUDA
  event recorded right after the copy that reads it.  ``acquire`` takes
  a pooled buffer whose copy has finished, allocates while fewer than
  ``depth`` buffers of the size are pooled, and only then waits on the
  oldest gate — the recycling queue's blocking pop (reference
  ``recycling_gpu.hpp:88-126``).  A buffer is never freed while a copy
  may still read it: pinned memory freed early could be handed to the
  next allocation and overwritten under the copy.
* :class:`PackedBatchBuilder` — streams SoA rows into one pooled buffer
  at their final packed offsets: every payload lane, the timestamp lane
  and the fill count ride ONE host buffer and ONE host→device copy.
* :func:`size_class` — the pool size of a data-dependent buffer: wire
  buffers (``wire.py``) vary in size with the data, so they are
  acquired at their size class and the pool's exact-size slots recycle
  them across codec churn.
* ``device_bytes`` — the process-wide staged-transfer gauge: bytes
  copied host→device (and their decoded size), batches staged; read by
  the ``Device`` section of ``PipeGraph.stats()``.

Buffer layout (shared with ``batch.py``'s unpack)::

    [lane0 words | lane1 words | ... | ts words (2/row) | n]

A 4-byte lane takes 1 word a row, an 8-byte integer lane 2 (lo/hi).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np

from windflow_tpu_torch.analysis import debug_concurrency as _dbg
from windflow_tpu_torch.analysis.hotpath import hot_path

#: retained buffers per distinct buffer size (the recycling queue depth)
DEFAULT_DEPTH = 4
#: global cap on bytes RETAINED by the pool
DEFAULT_MAX_BYTES = 256 << 20


def lane_words(dt) -> int:
    """uint32 words per row for one packed lane."""
    return 2 if np.dtype(dt).itemsize == 8 else 1


def packable_dtype(dt) -> bool:
    """Lanes that ride the packed buffer: any 4-byte dtype (a bit view on
    the device), or int64/uint64 as lo/hi word pairs."""
    dt = np.dtype(dt)
    return (dt.itemsize == 4) or dt in (np.dtype(np.int64),
                                        np.dtype(np.uint64))


def size_class(nwords: int) -> int:
    """Pool size class of a data-dependent buffer size: round up to 1/8
    granularity of the enclosing power of two (256-word floor).  Wire
    buffers vary in size with the data, so they are acquired at their
    class, not their exact size: codec churn across reseeds would
    otherwise mint a fresh (pinned, on the card) slot per batch.  Padding
    stays under 25% of the transfer (just past a power of two) and under
    12.5% on average."""
    if nwords <= 256:
        return 256
    step = 1 << max(0, (nwords - 1).bit_length() - 3)
    return ((nwords + step - 1) // step) * step


class StagingPool:
    """Size-keyed recycling pool of host ``uint32`` staging buffers.

    ``pinned`` allocates page-locked buffers (CUDA targets).  Thread-safe:
    the lock guards only the deque bookkeeping."""

    #: lock discipline declaration enforced by tools/wf_lint.py (WF721):
    #: the slot dict and retained-byte counter mutate only under _lock
    __lock_guards__ = {"_lock": ("_slots", "_held_bytes")}

    def __init__(self, depth: int = DEFAULT_DEPTH,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 pinned: bool = False) -> None:
        self.depth = max(1, depth)
        self.max_bytes = max_bytes
        self.pinned = pinned
        self._held_bytes = 0
        if _dbg.ENABLED:
            # race detector (analysis/debug_concurrency): the lock records
            # its owner, and every mutation of _slots and of the slot
            # deques it hands out asserts the lock is held
            self._lock = _dbg.DebugLock("StagingPool._lock")
            self._slots = _dbg.LockCheckedDict(self._lock,
                                               "StagingPool._slots")
            self._new_slot = lambda: _dbg.LockCheckedDeque(
                self._lock, "StagingPool._slots slot deque")
        else:
            self._slots = {}        # nwords -> deque[(buf, gate)]
            self._lock = threading.Lock()
            self._new_slot = deque
        self.hits = 0
        self.misses = 0
        self.releases = 0
        self.drops = 0
        self.gate_waits = 0

    def _alloc(self, nwords: int) -> np.ndarray:
        if not self.pinned:
            return np.empty(nwords, np.uint32)
        import torch
        # the numpy view keeps the pinned tensor alive (ndarray.base)
        return torch.empty(nwords, dtype=torch.int32,
                           pin_memory=True).numpy().view(np.uint32)

    def acquire(self, nwords: int) -> np.ndarray:
        """A ``uint32[nwords]`` host buffer: a pooled one whose copy has
        finished; else a fresh one while fewer than ``depth`` are pooled;
        else the oldest pooled one, after waiting on its gate.  Contents
        are undefined."""
        entry = None
        with self._lock:
            dq = self._slots.get(nwords)
            if dq:
                for i, (buf, gate) in enumerate(dq):
                    if gate is None or gate.query():
                        entry = (buf, None)
                        del dq[i]
                        break
                else:
                    if len(dq) >= self.depth:
                        entry = dq.popleft()
                if entry is not None:
                    self._held_bytes -= nwords * 4
                    self.hits += 1
            if entry is None:
                self.misses += 1
        if entry is None:
            return self._alloc(nwords)
        buf, gate = entry
        if gate is not None:
            self.gate_waits += 1
            gate.synchronize()
        return buf

    def release(self, buf: np.ndarray, gate=None) -> None:
        """Return a buffer for reuse; ``gate`` is a ``torch.cuda.Event``
        recorded after the copy that reads ``buf`` (None when nothing
        reads it asynchronously).  A pool at capacity drops the buffer,
        after its copy has finished."""
        with self._lock:
            dq = self._slots.setdefault(buf.shape[0], self._new_slot())
            if len(dq) < self.depth \
                    and self._held_bytes + buf.nbytes <= self.max_bytes:
                dq.append((buf, gate))
                self._held_bytes += buf.nbytes
                self.releases += 1
                return
            self.drops += 1
        if gate is not None:
            gate.synchronize()

    def stats(self) -> dict:
        """Counter snapshot (``PipeGraph.stats()["Staging_pool"]``)."""
        total = self.hits + self.misses
        with self._lock:
            held = self._held_bytes
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "releases": self.releases,
            "drops_at_capacity": self.drops,
            "gate_waits": self.gate_waits,
            "held_bytes": held,
            "depth": self.depth,
        }


_pools = {}
_pools_lock = threading.Lock()


def pools_stats() -> dict:
    """``StagingPool.stats`` summed over the process's pools (pinned and
    plain)."""
    with _pools_lock:
        pools = list(_pools.values())
    out = {"hits": 0, "misses": 0, "releases": 0, "drops_at_capacity": 0,
           "gate_waits": 0, "held_bytes": 0, "depth": DEFAULT_DEPTH}
    for p in pools:
        for k, v in p.stats().items():
            if k not in ("hit_rate", "depth"):
                out[k] += v
    total = out["hits"] + out["misses"]
    out["hit_rate"] = round(out["hits"] / total, 4) if total else 0.0
    return out


class _DeviceBytes:
    """Process-wide staged-transfer accounting: wire bytes actually
    copied host→device, their decoded (logical) size, and batches.
    Plain int adds at staging time."""

    __slots__ = ("staged_bytes_total", "staged_batches_total",
                 "logical_bytes_total")

    def __init__(self) -> None:
        self.staged_bytes_total = 0
        self.staged_batches_total = 0
        self.logical_bytes_total = 0

    def note(self, nbytes: int, logical_nbytes: Optional[int] = None) -> None:
        self.staged_bytes_total += nbytes
        self.logical_bytes_total += (logical_nbytes if logical_nbytes
                                     is not None else nbytes)
        self.staged_batches_total += 1

    def reset(self) -> None:
        self.staged_bytes_total = 0
        self.staged_batches_total = 0
        self.logical_bytes_total = 0


#: the staged-byte gauge (shared by every graph, like the pools)
device_bytes = _DeviceBytes()


def pool_for(device) -> StagingPool:
    """The process-wide pool for a staging target: pinned buffers for a
    CUDA device, plain numpy buffers for the CPU."""
    pinned = getattr(device, "type", str(device)) == "cuda"
    with _pools_lock:
        pool = _pools.get(pinned)
        if pool is None:
            pool = _pools[pinned] = StagingPool(pinned=pinned)
    return pool


class PackedBatchBuilder:
    """Streams SoA rows into one pooled staging buffer.

    ``dtypes`` lists the payload lanes in order (each packable); the int64
    timestamp lane and the fill-count word are implicit."""

    __slots__ = ("capacity", "dtypes", "_words", "_offsets", "total",
                 "buf", "n", "pool", "_lane_dtypes")

    def __init__(self, dtypes: Sequence, capacity: int,
                 pool: Optional[StagingPool] = None) -> None:
        self.pool = pool if pool is not None else pool_for("cpu")
        self.dtypes = tuple(np.dtype(d) for d in dtypes)
        if not all(packable_dtype(d) for d in self.dtypes):
            raise ValueError(f"unpackable lane dtypes {self.dtypes}")
        self._lane_dtypes = self.dtypes + (np.dtype(np.int64),)
        self._words = [lane_words(d) for d in self.dtypes] + [2]  # + ts
        self._offsets = []
        off = 0
        for w in self._words:
            self._offsets.append(off)
            off += w * capacity
        self.total = off + 1            # + fill-count word
        self.capacity = capacity
        self.buf = self.pool.acquire(self.total)
        self.n = 0

    @property
    def room(self) -> int:
        """Rows still free."""
        return self.capacity - self.n

    @hot_path
    def append(self, lanes: Sequence[np.ndarray], tss: np.ndarray) -> None:
        """Write ``len(tss)`` rows: ``lanes`` are 1-D payload columns in
        ``dtypes`` order, ``tss`` the int64 timestamps."""
        if _dbg.ENABLED:
            # a builder is single-consumer (one replica's emitter fills
            # it): overlapping appends are a race
            with _dbg.entry_guard(self, "PackedBatchBuilder.append"):
                return self._append_impl(lanes, tss)
        return self._append_impl(lanes, tss)

    @hot_path
    def _append_impl(self, lanes, tss) -> None:
        m = len(tss)
        for off, w, dt, lane in zip(self._offsets, self._words,
                                    self._lane_dtypes,
                                    itertools.chain(lanes, (tss,))):
            src = np.ascontiguousarray(lane, dt).view(np.uint32)
            lo = off + w * self.n
            self.buf[lo:lo + w * m] = src
        self.n += m

    @hot_path
    def finish(self) -> np.ndarray:
        """Zero each lane's unwritten tail, stamp the fill count, and hand
        the buffer over (the caller owns it until ``pool.release``)."""
        if _dbg.ENABLED:
            with _dbg.entry_guard(self, "PackedBatchBuilder.finish"):
                return self._finish_impl()
        return self._finish_impl()

    @hot_path
    def _finish_impl(self) -> np.ndarray:
        if self.n < self.capacity:
            for off, w in zip(self._offsets, self._words):
                self.buf[off + w * self.n:off + w * self.capacity] = 0
        self.buf[-1] = self.n
        return self.buf

    def abandon(self) -> None:
        """Return the unused buffer to the pool (nothing read it)."""
        self.pool.release(self.buf, None)
