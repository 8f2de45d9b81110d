"""The one traffic generator: a closed-loop replay of a seeded log.

A configuration states the record layout (``record``: the key and the
float64 value fields with their integer ranges); a traffic mix states
how the log is drawn and replayed (``traffic/<mix>.json``):

* ``pool_records``: records in the log held in host memory;
* ``event_rate_per_s``: event time advances ``1e6 / rate`` µs a record;
* ``hot_keys``, ``hot_share``: a burst of ``hot_keys`` keys drawn from
  the seed that carry ``hot_share`` of all records (0 for none);
* ``chunk_bytes``: the most bytes a fetch returns, whole records only.

The records are frames (little-endian ``int64 key, int64 ts, nv x
float64``, the port's ``io.frames`` format).  The log is replayed in a
loop: each chunk is handed over as soon as the source asks (a consumer
catching up on a backlog), and before a chunk is handed over again its
``ts`` fields are advanced in place by the log's span, so event time
keeps moving.  Record ``i`` of the stream has ``ts = i * gap``: a
timestamp names its record.  The generator records the host time at
which it handed over each chunk.
"""

from __future__ import annotations

import time

import numpy as np


def frame_dtype(nv: int) -> np.dtype:
    return np.dtype([("key", "<i8"), ("ts", "<i8"), ("v", "<f8", (nv,))])


def draw_pool(record: dict, traffic: dict, rng) -> np.ndarray:
    """The log: ``pool_records`` frames drawn from ``rng``."""
    n = int(traffic["pool_records"])
    fields = record["values"]
    pool = np.empty(n, frame_dtype(len(fields)))
    keys = rng.integers(0, int(record["key_range"]), n)
    hot = int(traffic.get("hot_keys", 0))
    if hot:
        ids = rng.choice(int(record["key_range"]), hot, replace=False)
        m = rng.random(n) < float(traffic["hot_share"])
        keys[m] = ids[rng.integers(0, hot, int(m.sum()))]
    pool["key"] = keys
    pool["ts"] = np.arange(n, dtype=np.int64) * event_gap_usec(traffic)
    for i, f in enumerate(fields):
        pool["v"][:, i] = rng.integers(0, int(f["range"]), n)
    return pool


def event_gap_usec(traffic: dict) -> int:
    gap, rem = divmod(1_000_000, int(traffic["event_rate_per_s"]))
    if rem or gap < 1:
        raise ValueError("event_rate_per_s must divide 1,000,000")
    return gap


class ChunkStream:
    """Replays ``pool`` in chunks of whole records.

    The chunks holding the first ``warmup_records`` go out first
    (set-up); the measured window starts as the next chunk is handed over
    and ends at the first request ``seconds`` later, which gets end of
    stream."""

    def __init__(self, pool: np.ndarray, traffic: dict,
                 warmup_records: int, seconds: float) -> None:
        self.pool = pool
        self.n = len(pool)
        self.gap = event_gap_usec(traffic)
        self.span = self.n * self.gap
        self.chunk_records = int(traffic["chunk_bytes"]) // pool.itemsize
        if self.chunk_records < 1:
            raise ValueError("chunk_bytes is below one record")
        self.chunks_per_pass = -(-self.n // self.chunk_records)
        self.warmup_chunks = -(-int(warmup_records) // self.chunk_records)
        self.seconds = float(seconds)
        self.bytes = pool.view(np.uint8).reshape(-1)
        self.handed = np.zeros(1 << 16)     # host time of each chunk
        self.handed_n = 0
        self.t_start = None
        self.stop_at = None

    def chunk_bounds(self, k: int):
        c = k % self.chunks_per_pass
        lo = c * self.chunk_records
        return lo, min(self.n, lo + self.chunk_records)

    def records_before(self, k: int) -> int:
        """Records in chunks ``[0, k)``."""
        p, c = divmod(k, self.chunks_per_pass)
        return p * self.n + min(self.n, c * self.chunk_records)

    def chunk_of(self, index):
        """The chunk that carried stream record ``index`` (array-wise)."""
        p, i = np.divmod(np.asarray(index, np.int64), self.n)
        return p * self.chunks_per_pass + i // self.chunk_records

    def __call__(self):
        k = 0
        ts = self.pool["ts"]
        isz = self.pool.itemsize
        while True:
            now = time.perf_counter()
            if k == self.warmup_chunks:
                self.t_start = now
            elif k > self.warmup_chunks \
                    and now - self.t_start >= self.seconds:
                self.stop_at = k
                return
            lo, hi = self.chunk_bounds(k)
            if k >= self.chunks_per_pass:
                ts[lo:hi] += self.span      # this chunk's next pass
            if self.handed_n == len(self.handed):
                self.handed = np.concatenate([self.handed,
                                              np.zeros(len(self.handed))])
            self.handed[k] = now
            self.handed_n = k + 1
            yield memoryview(self.bytes[lo * isz:hi * isz])
            k += 1

    # -- what was handed over -------------------------------------------
    @property
    def chunks(self) -> int:
        return self.handed_n

    @property
    def records(self) -> int:
        return self.records_before(self.handed_n)

    @property
    def window_records(self) -> int:
        return self.records - self.records_before(self.warmup_chunks)
