"""Embedded key/value store (the port of ``windflow_tpu/persistent/
kv.py``; the RocksDB analogue of the reference, ``db_handle.hpp:53-140``):
byte keys to byte values in one append-only log, durable across process
restarts when the path is kept.

The on-disk format is the JAX package's, byte for byte: records of
``<u32 klen, i64 vlen>`` headers (``vlen == -1`` is a tombstone) followed
by the key and value, a torn tail truncated at open.  The fast path is
the native log-structured store (``native/wf_kv.cpp``, the port's own
copy, loaded via ctypes); the pure-Python backend speaks the same
format and is the fallback (``WF_TPU_NO_NATIVE=1``).  A store written
by either backend of either package opens under every other.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, List, Optional, Tuple

from windflow_tpu_torch import native

_HDR = struct.Struct("<Iq")  # u32 klen, i64 vlen (-1 = tombstone)
_MAX_KEY = 1 << 20           # writer cap == scanner sanity bound


class _PyKV:
    """Pure-Python log-structured store."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "a+b")
        self._index: Dict[bytes, Tuple[int, int]] = {}
        self._live = 0
        self._end = self._scan()
        self._f.truncate(self._end)  # drop any torn tail

    def _scan(self) -> int:
        f = self._f
        f.seek(0, os.SEEK_END)
        size = f.tell()
        off = 0
        while off + _HDR.size <= size:
            f.seek(off)
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            klen, vlen = _HDR.unpack(hdr)
            if vlen < -1 or klen > _MAX_KEY:
                break
            rec = _HDR.size + klen + max(vlen, 0)
            if off + rec > size:
                break
            key = f.read(klen)
            old = self._index.pop(key, None)
            if old is not None:
                self._live -= _HDR.size + klen + max(old[1], 0)
            if vlen >= 0:
                self._index[key] = (off + _HDR.size + klen, vlen)
                self._live += rec
            off += rec
        return off

    def _append(self, key: bytes, val: Optional[bytes]) -> None:
        if len(key) > _MAX_KEY:
            raise ValueError(
                f"key of {len(key)} bytes exceeds the {_MAX_KEY}-byte cap "
                "(the open-time log scan would treat it as corruption)")
        vlen = -1 if val is None else len(val)
        self._f.seek(self._end)
        self._f.write(_HDR.pack(len(key), vlen) + key + (val or b""))
        self._end += _HDR.size + len(key) + max(vlen, 0)

    def put(self, key: bytes, val: bytes) -> None:
        off = self._end + _HDR.size + len(key)
        self._append(key, val)
        old = self._index.get(key)
        if old is not None:
            self._live -= _HDR.size + len(key) + max(old[1], 0)
        self._index[key] = (off, len(val))
        self._live += _HDR.size + len(key) + len(val)

    def get(self, key: bytes) -> Optional[bytes]:
        e = self._index.get(key)
        if e is None:
            return None
        self._f.seek(e[0])
        return self._f.read(e[1])

    def delete(self, key: bytes) -> bool:
        e = self._index.get(key)
        if e is None:
            return False
        # tombstone first: if the append fails (ENOSPC), the index must keep
        # matching the log or the record would resurrect on reopen
        self._append(key, None)
        del self._index[key]
        self._live -= _HDR.size + len(key) + max(e[1], 0)
        return True

    def keys(self) -> List[bytes]:
        return list(self._index.keys())

    def count(self) -> int:
        return len(self._index)

    def log_bytes(self) -> int:
        return self._end

    def live_bytes(self) -> int:
        return self._live

    def compact(self) -> None:
        tmp = self.path + ".compact"
        with open(tmp, "wb") as out:
            nindex = {}
            off = 0
            for key, (voff, vlen) in self._index.items():
                self._f.seek(voff)
                val = self._f.read(vlen)
                out.write(_HDR.pack(len(key), vlen) + key + val)
                nindex[key] = (off + _HDR.size + len(key), vlen)
                off += _HDR.size + len(key) + vlen
            out.flush()
            os.fsync(out.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "r+b")
        self._index = nindex
        self._end = off
        self._live = off

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self, delete_db: bool = False) -> None:
        self._f.close()
        if delete_db and os.path.exists(self.path):
            os.unlink(self.path)


class _NativeKV:
    """ctypes wrapper over ``native/wf_kv.cpp``."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._L = native.lib()
        self._h = self._L.wf_kv_open(path.encode(), 1)
        if not self._h:
            raise OSError(f"wf_kv_open failed for {path!r}")
        native._count("kv_open")

    def put(self, key: bytes, val: bytes) -> None:
        if len(key) > _MAX_KEY:
            raise ValueError(
                f"key of {len(key)} bytes exceeds the {_MAX_KEY}-byte cap")
        if self._L.wf_kv_put(self._h, key, len(key), val, len(val)) != 0:
            raise OSError(f"wf_kv_put failed for {self.path!r}")
        native._count("kv_put")

    def get(self, key: bytes) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(4096)
        n = self._L.wf_kv_get(self._h, key, len(key), buf, len(buf))
        if n < 0:
            return None
        if n > len(buf):
            buf = ctypes.create_string_buffer(n)
            n = self._L.wf_kv_get(self._h, key, len(key), buf, len(buf))
        return buf.raw[:n]

    def delete(self, key: bytes) -> bool:
        ret = self._L.wf_kv_del(self._h, key, len(key))
        if ret < 0:
            raise OSError(f"wf_kv_del failed for {self.path!r} "
                          "(tombstone write error)")
        return bool(ret)

    def keys(self) -> List[bytes]:
        it = self._L.wf_kv_iter_new(self._h)
        out = []
        buf = ctypes.create_string_buffer(4096)
        try:
            while True:
                n = self._L.wf_kv_iter_next(it, buf, len(buf))
                if n < 0:
                    break
                if n > len(buf):
                    buf = ctypes.create_string_buffer(n)
                    continue
                out.append(buf.raw[:n])
        finally:
            self._L.wf_kv_iter_destroy(it)
        return out

    def count(self) -> int:
        return self._L.wf_kv_count(self._h)

    def log_bytes(self) -> int:
        return self._L.wf_kv_log_bytes(self._h)

    def live_bytes(self) -> int:
        return self._L.wf_kv_live_bytes(self._h)

    def compact(self) -> None:
        if self._L.wf_kv_compact(self._h) != 0:
            raise OSError(f"wf_kv_compact failed for {self.path!r}")

    def flush(self) -> None:
        self._L.wf_kv_flush(self._h)

    def close(self, delete_db: bool = False) -> None:
        if self._h:
            self._L.wf_kv_close(self._h, int(delete_db))
            self._h = None


class LogKV:
    """One open store.  Auto-compacts when the log grows past
    ``compact_ratio`` times the live data (LSM-style space reclamation;
    the reference delegates this to RocksDB's level compaction)."""

    def __init__(self, path: str, compact_ratio: float = 4.0,
                 min_compact_bytes: int = 1 << 20) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        backend = _NativeKV if native.is_available() else _PyKV
        self._kv = backend(path)
        self.path = path
        self.compact_ratio = compact_ratio
        self.min_compact_bytes = min_compact_bytes

    def put(self, key: bytes, val: bytes) -> None:
        self._kv.put(key, val)
        if (self._kv.log_bytes() > self.min_compact_bytes
                and self._kv.log_bytes()
                > self.compact_ratio * max(self._kv.live_bytes(), 1)):
            self._kv.compact()

    def get(self, key: bytes) -> Optional[bytes]:
        return self._kv.get(key)

    def delete(self, key: bytes) -> bool:
        return self._kv.delete(key)

    def keys(self) -> List[bytes]:
        return self._kv.keys()

    def __len__(self) -> int:
        return self._kv.count()

    def log_bytes(self) -> int:
        return self._kv.log_bytes()

    def live_bytes(self) -> int:
        return self._kv.live_bytes()

    def compact(self) -> None:
        self._kv.compact()

    def flush(self) -> None:
        self._kv.flush()

    def close(self, delete_db: bool = False) -> None:
        self._kv.close(delete_db)


# ---------------------------------------------------------------------------
# Shared-store registry: replicas of an operator built with a shared DB (the
# reference's _sharedDb flag) resolve the same path to one refcounted LogKV
# handle.
# ---------------------------------------------------------------------------

_open_stores: Dict[str, Tuple[LogKV, int]] = {}


def open_shared(path: str) -> LogKV:
    ap = os.path.abspath(path)
    if ap in _open_stores:
        kv, rc = _open_stores[ap]
        _open_stores[ap] = (kv, rc + 1)
        return kv
    kv = LogKV(ap)
    _open_stores[ap] = (kv, 1)
    return kv


def close_shared(path: str, delete_db: bool = False) -> None:
    ap = os.path.abspath(path)
    if ap not in _open_stores:
        return
    kv, rc = _open_stores[ap]
    if rc > 1:
        _open_stores[ap] = (kv, rc - 1)
        return
    del _open_stores[ap]
    kv.close(delete_db)
