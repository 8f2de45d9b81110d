"""Fluent builders for the persistent operator suite (the port of
``windflow_tpu/persistent/builders.py``; reference
``persistent/builders_rocksdb.hpp:59-1502``).

All support ``withDBPath``, ``withSharedDb``, ``withKeepDb``,
``withSerializer``/``withDeserializer`` (defaults: pickle) and
``withInitialState``; `P_Keyed_Windows_Builder` adds the window clauses plus
``withMaxInMemoryElements`` (the reference's volatile-fragment capacity,
``p_window_replica.hpp:93``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.graph.builders import (_BuilderBase,
                                               _WindowBuilderBase,
                                               _detect_incremental)
from windflow_tpu_torch.persistent.ops import (PFilter, PFlatMap, PMap,
                                               PReduce, PSink)
from windflow_tpu_torch.persistent.p_windows import PKeyedWindows


def _default_db_path(name: str) -> str:
    # Reference default: DBs under a fixed scratch root unless the user
    # chooses a path (builders_rocksdb.hpp dbpath arguments).
    root = os.environ.get("WF_TPU_DB_DIR",
                          os.path.join(tempfile.gettempdir(), "windflow_db"))
    return os.path.join(root, name)


class _PersistentBuilderMixin:
    def __init__(self) -> None:
        self._db_path: Optional[str] = None
        self._initial_state: Any = None
        self._serialize = None
        self._deserialize = None
        self._shared_db = False
        self._keep_db = False

    def withDBPath(self, path: str):
        self._db_path = path
        return self

    # reference-spelled aliases (builders_rocksdb.hpp withDbPath /
    # withDeleteDb) so transliterated programs work unchanged
    def withDbPath(self, path: str):
        return self.withDBPath(path)

    def withDeleteDb(self, delete: bool = True):
        return self.withKeepDb(not delete)

    def withInitialState(self, state: Any):
        """Initial per-key state: a value (deep-copied per key) or a zero-arg
        factory."""
        self._initial_state = state
        return self

    def withSerializer(self, fn: Callable[[Any], bytes]):
        self._serialize = fn
        return self

    def withDeserializer(self, fn: Callable[[bytes], Any]):
        self._deserialize = fn
        return self

    def withSharedDb(self, shared: bool = True):
        self._shared_db = shared
        return self

    def withKeepDb(self, keep: bool = True):
        """Keep the DB on disk after the run (reference: !deleteDb)."""
        self._keep_db = keep
        return self

    def _db_kwargs(self, name: str) -> dict:
        return dict(db_path=self._db_path or _default_db_path(name),
                    serialize=self._serialize,
                    deserialize=self._deserialize,
                    shared_db=self._shared_db,
                    keep_db=self._keep_db)


class _PersistentOpBuilder(_PersistentBuilderMixin, _BuilderBase):
    _op_class = None

    def __init__(self, fn: Callable) -> None:
        _BuilderBase.__init__(self)
        _PersistentBuilderMixin.__init__(self)
        self._fn = fn

    def withRebalancing(self):
        raise WindFlowError(
            "persistent operators route by key (their state is keyed); "
            "REBALANCING does not apply")

    def build(self):
        return self._op_class(
            self._fn, name=self._name, parallelism=self._parallelism,
            key_extractor=self._key_extractor,
            initial_state=self._initial_state,
            output_batch_size=self._output_batch_size,
            **self._db_kwargs(self._name))


class P_Map_Builder(_PersistentOpBuilder):
    _default_name = "p_map"
    _op_class = PMap


class P_Filter_Builder(_PersistentOpBuilder):
    _default_name = "p_filter"
    _op_class = PFilter


class P_FlatMap_Builder(_PersistentOpBuilder):
    _default_name = "p_flatmap"
    _op_class = PFlatMap


class P_Reduce_Builder(_PersistentOpBuilder):
    _default_name = "p_reduce"
    _op_class = PReduce


class P_Sink_Builder(_PersistentOpBuilder):
    _default_name = "p_sink"
    _op_class = PSink

    def withOutputBatchSize(self, *_):
        raise WindFlowError("a Sink has no output to batch")

    def build(self):
        return PSink(
            self._fn, name=self._name, parallelism=self._parallelism,
            key_extractor=self._key_extractor,
            initial_state=self._initial_state,
            **self._db_kwargs(self._name))


class P_Keyed_Windows_Builder(_PersistentBuilderMixin, _WindowBuilderBase):
    _default_name = "p_keyed_windows"

    def __init__(self, fn: Callable) -> None:
        _WindowBuilderBase.__init__(self)
        _PersistentBuilderMixin.__init__(self)
        self._fn = fn
        self._n_max_elements = 1024

    def withMaxInMemoryElements(self, n: int):
        self._n_max_elements = int(n)
        return self

    def build(self) -> PKeyedWindows:
        return PKeyedWindows(
            self._fn, self._spec(), name=self._name,
            parallelism=self._parallelism, key_extractor=self._key_extractor,
            incremental=_detect_incremental(self._fn),
            n_max_elements=self._n_max_elements,
            output_batch_size=self._output_batch_size,
            **self._db_kwargs(self._name))
