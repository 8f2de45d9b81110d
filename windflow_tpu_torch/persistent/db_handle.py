"""Typed handle over the embedded KV store (the port of
``windflow_tpu/persistent/db_handle.py``).

Re-design of the reference ``DBHandle<T>`` (``persistent/
db_handle.hpp:53-140``): serialize/deserialize functions turn operator state
into bytes, ``get`` returns a fresh copy of ``initial_state`` for unseen
keys, and the handle either owns a private store or shares one with the
other replicas of its operator (the reference's ``_sharedDb`` flag appends
``"_shared"`` to the path, ``p_map.hpp:92-99``; private handles suffix the
replica index).  Keys and values are encoded as in the JAX package, so
a store either package wrote reopens under the other.
"""

from __future__ import annotations

import copy
import pickle
from typing import Any, Callable, List, Optional

from windflow_tpu_torch.persistent import kv as kvmod


def default_serialize(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


default_deserialize = pickle.loads


class DBHandle:
    def __init__(self, db_path: str,
                 serialize: Callable[[Any], bytes] = None,
                 deserialize: Callable[[bytes], Any] = None,
                 initial_state: Any = None,
                 shared: bool = False,
                 whoami: int = 0,
                 delete_db: bool = True) -> None:
        self.serialize = serialize or default_serialize
        self.deserialize = deserialize or default_deserialize
        self.initial_state = initial_state
        self.shared = shared
        self.delete_db = delete_db
        self.path = (db_path + "_shared") if shared \
            else f"{db_path}_r{whoami}"
        self._kv: Optional[kvmod.LogKV] = kvmod.open_shared(self.path) \
            if shared else kvmod.LogKV(self.path)
        self._closed = False

    # -- key encoding --------------------------------------------------------
    @staticmethod
    def key_bytes(key: Any) -> bytes:
        # Stable for the hashable key types streams use (ints, strings,
        # tuples); the reference serializes keys with the same user-supplied
        # mechanism as values.
        if isinstance(key, bytes):
            return b"b" + key
        if isinstance(key, str):
            return b"s" + key.encode()
        if isinstance(key, int):
            return b"i%d" % key
        return b"p" + pickle.dumps(key, protocol=4)

    @staticmethod
    def key_from_bytes(kb: bytes) -> Any:
        tag, rest = kb[:1], kb[1:]
        if tag == b"b":
            return rest
        if tag == b"s":
            return rest.decode()
        if tag == b"i":
            return int(rest)
        return pickle.loads(rest)

    # -- state access (the per-input read-modify-write loop,
    #    reference p_map.hpp:178-211) ----------------------------------------
    def new_state(self) -> Any:
        init = self.initial_state
        return init() if callable(init) else copy.deepcopy(init)

    def get(self, key: Any) -> Any:
        raw = self._kv.get(self.key_bytes(key))
        if raw is None:
            return self.new_state()
        return self.deserialize(raw)

    def lookup(self, key: Any) -> Optional[Any]:
        """Like get, but None (no initial state) for unseen keys."""
        raw = self._kv.get(self.key_bytes(key))
        return None if raw is None else self.deserialize(raw)

    def put(self, key: Any, state: Any) -> None:
        self._kv.put(self.key_bytes(key), self.serialize(state))

    def delete(self, key: Any) -> bool:
        return self._kv.delete(self.key_bytes(key))

    def keys(self) -> List[Any]:
        return [self.key_from_bytes(kb) for kb in self._kv.keys()]

    def __len__(self) -> int:
        return len(self._kv)

    # -- lifecycle -----------------------------------------------------------
    def flush(self) -> None:
        self._kv.flush()

    def close(self) -> None:
        """Close (and delete unless the DB is to be kept — reference deletes
        on destruction when ``deleteDb``, ``db_handle.hpp:108-112``)."""
        if self._closed:
            return
        self._closed = True
        if self.shared:
            kvmod.close_shared(self.path, self.delete_db)
        else:
            self._kv.close(self.delete_db)
