"""Persistent keyed windows: archives spill to the embedded KV store (the
port of ``windflow_tpu/persistent/p_windows.py``).

Re-design of the reference ``P_Keyed_Windows`` (``persistent/
p_keyed_windows.hpp:67``) and its ``P_Window_Replica``
(``p_window_replica.hpp:70-``): each key buffers up to ``n_max_elements``
tuples in memory; a full buffer is flushed to the store as a *fragment*
carrying (min, max, id) domain metadata, and window firing reloads only the
fragments whose [min, max] range overlaps the window — so window archives
can exceed RAM (the reference's sequence-scaling mechanism).  Incremental logic keeps per-window accumulators in memory (the
reference's ``results_in_memory`` default) and needs no archive at all.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from windflow_tpu_torch.persistent.db_handle import DBHandle
from windflow_tpu_torch.windows.engine import Archive, WindowSpec
from windflow_tpu_torch.windows.ops import KeyedWindows, _WindowReplicaBase


class SpillingArchive(Archive):
    """KV-backed archive of ``(domain, aid, item, ts)`` entries for one key."""

    __slots__ = ("_db", "_key", "_n_max", "_mem", "_frags", "_next_frag",
                 "_min", "_max")

    def __init__(self, db: DBHandle, key: Any, n_max: int) -> None:
        self._db = db
        self._key = key
        self._n_max = max(1, n_max)
        self._mem: List = []
        # fragment metadata: (min_domain, max_domain, frag_id, count) —
        # reference meta_frag_t (p_window_replica.hpp:92)
        self._frags: List[Tuple[int, int, int, int]] = []
        self._next_frag = 0
        self._min = None
        self._max = None

    def _frag_key(self, frag_id: int) -> Any:
        return ("__frag__", self._key, frag_id)

    def insert(self, entry) -> None:
        if len(self._mem) >= self._n_max:
            fid = self._next_frag
            self._next_frag += 1
            self._frags.append((self._min, self._max, fid, len(self._mem)))
            self._db.put(self._frag_key(fid), self._mem)
            self._mem = []
            self._min = self._max = None
        d = entry[0]
        self._min = d if self._min is None else min(self._min, d)
        self._max = d if self._max is None else max(self._max, d)
        self._mem.append(entry)

    def range(self, start: int, end: int) -> List:
        out = []
        for (lo, hi, fid, _n) in self._frags:
            # fragment useful iff its [lo, hi] overlaps [start, end)
            # (reference check_range_mm, p_window_replica.hpp:124-131)
            if hi >= start and lo < end:
                out.extend(e for e in self._db.lookup(self._frag_key(fid))
                           if start <= e[0] < end)
        out.extend(e for e in self._mem if start <= e[0] < end)
        out.sort(key=lambda e: e[:2])
        return out

    def purge_below(self, d: int) -> None:
        keep = []
        for frag in self._frags:
            if frag[1] < d:  # max domain below the horizon: fully dead
                self._db.delete(self._frag_key(frag[2]))
            else:
                keep.append(frag)
        self._frags = keep
        self._mem = [e for e in self._mem if e[0] >= d]
        self._recompute_mm()

    def clear(self) -> None:
        for frag in self._frags:
            self._db.delete(self._frag_key(frag[2]))
        self._frags = []
        self._mem = []
        self._min = self._max = None

    def _recompute_mm(self) -> None:
        # keep the buffer's min/max tight after purges, or the next spilled
        # fragment's metadata would cover phantom domains (making range()
        # load it needlessly and purge_below() never reclaim it)
        if self._mem:
            ds = [e[0] for e in self._mem]
            self._min, self._max = min(ds), max(ds)
        else:
            self._min = self._max = None

    def __len__(self) -> int:
        return len(self._mem) + sum(f[3] for f in self._frags)

    @property
    def spilled_fragments(self) -> int:
        return len(self._frags)


class PKeyedWindowsReplica(_WindowReplicaBase):
    def __init__(self, op: "PKeyedWindows", index: int) -> None:
        super().__init__(op, index)
        self.db = DBHandle(op.db_path,
                           serialize=op.serialize,
                           deserialize=op.deserialize,
                           shared=op.shared_db,
                           whoami=index,
                           delete_db=not op.keep_db)

    def on_eos(self):
        super().on_eos()   # fires remaining windows (may reload fragments)
        self.db.close()


class PKeyedWindows(KeyedWindows):
    replica_class = PKeyedWindowsReplica

    def __init__(self, fn, spec: WindowSpec, *, db_path: str,
                 name: str = "p_keyed_windows", parallelism: int = 1,
                 key_extractor: Optional[Callable] = None,
                 incremental: bool = False,
                 n_max_elements: int = 1024,
                 serialize: Callable[[Any], bytes] = None,
                 deserialize: Callable[[bytes], Any] = None,
                 shared_db: bool = False,
                 keep_db: bool = False,
                 output_batch_size: int = 0) -> None:
        super().__init__(fn, spec, name=name, parallelism=parallelism,
                         key_extractor=key_extractor, incremental=incremental,
                         output_batch_size=output_batch_size)
        self.db_path = db_path
        self.n_max_elements = n_max_elements
        self.serialize = serialize
        self.deserialize = deserialize
        self.shared_db = shared_db
        self.host_pool_safe = not shared_db  # see persistent/ops.py
        self.keep_db = keep_db

    def _engine_kwargs(self, replica):
        kw = super()._engine_kwargs(replica)
        kw["archive_factory"] = lambda key: SpillingArchive(
            replica.db, key, self.n_max_elements)
        return kw
