"""Per-replica runtime context handed to "riched" user functions.

Equivalent of the reference's ``RuntimeContext`` (reference ``wf/context.hpp:53-120``)
and ``LocalStorage`` (``local_storage.hpp:56-100``): replica index/parallelism,
the timestamp/watermark of the input being processed, and a name→object store
for user state that must live with the replica.
"""

from __future__ import annotations

from typing import Any, Dict


class LocalStorage:
    """Typed name→value store (reference ``local_storage.hpp:56-100``).
    Python needs no ``void*`` gymnastics — any object can be stored."""

    def __init__(self) -> None:
        self._store: Dict[str, Any] = {}

    def is_contained(self, name: str) -> bool:
        return name in self._store

    def get(self, name: str, default: Any = None) -> Any:
        return self._store.setdefault(name, default)

    def put(self, name: str, value: Any) -> None:
        self._store[name] = value

    def remove(self, name: str) -> None:
        self._store.pop(name, None)


class RuntimeContext:
    """Reference ``context.hpp:53-120``: identifies the replica and exposes the
    metadata of the input currently being processed."""

    def __init__(self, parallelism: int, replica_index: int,
                 operator_name: str = "") -> None:
        self._parallelism = parallelism
        self._replica_index = replica_index
        self._operator_name = operator_name
        self._current_ts = 0
        self._current_wm = 0
        self.local_storage = LocalStorage()

    # -- identification -----------------------------------------------------
    @property
    def parallelism(self) -> int:
        return self._parallelism

    @property
    def replica_index(self) -> int:
        return self._replica_index

    @property
    def operator_name(self) -> str:
        return self._operator_name

    # -- per-input metadata (set by the replica before each user call) ------
    def _set_context(self, ts: int, wm: int) -> None:
        self._current_ts = ts
        self._current_wm = wm

    def get_current_timestamp(self) -> int:
        return self._current_ts

    def get_last_watermark(self) -> int:
        return self._current_wm
