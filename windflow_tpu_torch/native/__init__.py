"""ctypes bindings for the native host runtime (the port of
``windflow_tpu/native/__init__.py``, over the port's own copies of
``wf_host.cpp`` and ``wf_kv.cpp``).

The native layer mirrors the reference's C++ runtime surface (keyby
hashing, the watermark plumbing): bulk ingest parsing
(:func:`parse_frames`, :func:`parse_csv`), frames written straight into
a packed staging buffer (:func:`scan_frames`, :func:`pack_frames`), key
partitioning
(:func:`keyby_partition`), the watermark fold (:func:`min_watermark`)
and the log-structured KV store behind ``persistent/kv.py`` (the
``wf_kv_*`` entry points of :func:`lib`).

The library is built with ``make`` (g++) at first use, from the sources
beside this module, into ``windflow_tpu_torch/build/native/`` (git
ignores ``build/``) under a name keyed by a hash of the sources and of
the CPU's instruction-set flags (``-march=native``), so a later process
on a like host reuses it and an edited source builds anew.  The build
runs in a private temporary directory and the result is published with
one ``os.replace``: concurrent builders (pytest-xdist workers) each make
their own copy, and a reader never opens a half-written library.

Every wrapper keeps the JAX package's numpy fallback, the plain twin the
tests hold the native path against; ``WF_TPU_NO_NATIVE=1`` (read at every
call) selects it.  The two staging wrappers have no twin: their one
caller (``io/frames.py``) takes them only while the library is loaded,
and the parse-and-cast route otherwise, which the tests hold them
against.  A fallback that nobody asked for is visible:
:func:`is_available` is False and :func:`build_error` says why, and
:func:`call_counts` counts the calls that entered the library (per
wrapper; ``kv_open`` and ``kv_put`` for the native KV store).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

import numpy as np

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("wf_host.cpp", "wf_kv.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "build", "native")

_lib = None
_load_attempted = False
_build_error: Optional[str] = None
_lock = threading.Lock()

#: calls that entered the native library, by wrapper
_calls: Dict[str, int] = {}


def _count(name: str) -> None:
    _calls[name] = _calls.get(name, 0) + 1


def call_counts() -> Dict[str, int]:
    """Calls that ran natively since the last :func:`reset_call_counts`."""
    return dict(_calls)


def reset_call_counts() -> None:
    _calls.clear()


def _cpu_tag() -> bytes:
    """The host CPU's instruction-set flags: the Makefile builds with
    ``-march=native``, so a library is reused only on a like CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def so_path() -> str:
    """Where the library for the current sources and CPU lives (built or
    not)."""
    h = hashlib.sha256(_cpu_tag())
    for src in _SOURCES + ("Makefile",):
        with open(os.path.join(_NATIVE_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwfhost-{h.hexdigest()[:12]}.so")


def _build(final: str) -> None:
    """Compile into a private directory, then publish atomically."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for src in _SOURCES + ("Makefile",):
            shutil.copy(os.path.join(_NATIVE_DIR, src), tmp)
        subprocess.run(["make", "-C", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(os.path.join(tmp, "libwfhost.so"), final)


def build() -> str:
    """Build the library now if it is not built yet; returns its path.
    Raises when the toolchain fails (``lib()`` records that instead)."""
    final = so_path()
    if not os.path.exists(final):
        _build(final)
    return final


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    i8, i4, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
    p = ctypes.c_void_p
    c = ctypes.c_char_p
    sigs = {
        "wf_hash64": (u8, [i8]),
        "wf_keyby_partition": (None, [p, i8, i4, p, p]),
        "wf_frame_record_bytes": (i8, [i4]),
        "wf_parse_frames": (i8, [p, i8, i4, p, p, p, i8]),
        "wf_scan_frames": (None, [p, i8, i4, p]),
        "wf_pack_frames": (None, [p, i4, i8, i8, p, p, i4, i8, p]),
        "wf_parse_csv": (i8, [p, i8, i4, p, p, p, i8, p]),
        "wf_min_watermark": (i8, [p, i4, i8]),
        "wf_kv_open": (p, [c, i4]),
        "wf_kv_put": (i4, [p, c, i4, c, i8]),
        "wf_kv_get": (i8, [p, c, i4, p, i8]),
        "wf_kv_del": (i4, [p, c, i4]),
        "wf_kv_count": (i8, [p]),
        "wf_kv_log_bytes": (i8, [p]),
        "wf_kv_live_bytes": (i8, [p]),
        "wf_kv_compact": (i4, [p]),
        "wf_kv_flush": (i4, [p]),
        "wf_kv_close": (None, [p, i4]),
        "wf_kv_iter_new": (p, [p]),
        "wf_kv_iter_next": (i4, [p, p, i4]),
        "wf_kv_iter_destroy": (None, [p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(L, name)
        fn.restype = res
        fn.argtypes = args
    return L


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it first if needed; None under
    ``WF_TPU_NO_NATIVE`` or when the build failed (:func:`build_error`)."""
    global _lib, _load_attempted, _build_error
    if os.environ.get("WF_TPU_NO_NATIVE"):
        return None
    if _lib is not None or _load_attempted:
        return _lib
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            _lib = _bind(ctypes.CDLL(build()))
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            err = getattr(e, "stderr", None)
            _build_error = f"{type(e).__name__}: {e}" + (
                f"\n{err.decode(errors='replace')[-2000:]}" if err else "")
            _lib = None
    return _lib


def is_available() -> bool:
    return lib() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or was never
    asked for)."""
    return _build_error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# High-level wrappers (numpy in / numpy out, with the numpy fallbacks)
# ---------------------------------------------------------------------------

_SM_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_C2 = np.uint64(0x94D049BB133111EB)
_SM_ADD = np.uint64(0x9E3779B97F4A7C15)


def hash64(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (matches the native wf_hash64 bit-for-bit)."""
    x = keys.astype(np.uint64) + _SM_ADD
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _SM_C1
        x = (x ^ (x >> np.uint64(27))) * _SM_C2
    return x ^ (x >> np.uint64(31))


def keyby_partition(keys: np.ndarray, ndest: int):
    """(dests int32[n], counts int64[ndest]): hash-routing of each tuple."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = len(keys)
    L = lib()
    if L is not None:
        _count("keyby_partition")
        dests = np.empty(n, np.int32)
        counts = np.empty(ndest, np.int64)
        L.wf_keyby_partition(_ptr(keys), n, ndest, _ptr(dests), _ptr(counts))
        return dests, counts
    dests = (hash64(keys) % np.uint64(ndest)).astype(np.int32)
    counts = np.bincount(dests, minlength=ndest).astype(np.int64)
    return dests, counts


def frame_record_bytes(nv: int) -> int:
    return 16 + 8 * nv


def parse_frames(buf: bytes, nv: int, max_records: int = 2 ** 62):
    """Parse binary records (int64 key, int64 ts, nv×float64) into columns.
    Returns (keys, tss, vals[n, nv], consumed_bytes); the fallback is
    ``io/parse.parse_frames``."""
    L = lib()
    if L is None:
        from windflow_tpu_torch.io import parse
        return parse.parse_frames(buf, nv, max_records)
    _count("parse_frames")
    rec = frame_record_bytes(nv)
    n = min(len(buf) // rec, max_records)
    keys = np.empty(n, np.int64)
    tss = np.empty(n, np.int64)
    vals = np.empty((n, nv), np.float64)
    raw = np.frombuffer(buf, np.uint8)
    got = L.wf_parse_frames(_ptr(raw), len(buf), nv, _ptr(keys), _ptr(tss),
                            _ptr(vals), n)
    assert got == n
    return keys, tss, vals, n * rec


def scan_frames(raw: np.ndarray, nrec: int, nv: int):
    """``(key_min, key_max, ts_max)`` over the first ``nrec >= 1`` whole
    records of the frames in ``raw`` (a uint8 view).  Native only."""
    if not 1 <= nrec <= raw.size // frame_record_bytes(nv):
        raise ValueError(f"{nrec} records of {frame_record_bytes(nv)} "
                         f"bytes in a buffer of {raw.size}")
    _count("scan_frames")
    out = np.empty(3, np.int64)
    lib().wf_scan_frames(_ptr(raw), nrec, nv, _ptr(out))
    return int(out[0]), int(out[1]), int(out[2])


def pack_frames(raw: np.ndarray, nv: int, rec0: int, take: int,
                dst: np.ndarray, lane_off: np.ndarray, key_words: int,
                run_max: int):
    """Write records ``[rec0, rec0 + take)`` of the frames in ``raw`` (a
    uint8 view) into the uint32 staging buffer ``dst``: the key at word
    ``lane_off[0]`` on (int32 when ``key_words`` is 1, else int64), value
    ``v`` cast to float32 at ``lane_off[1 + v]``, the int64 ts at
    ``lane_off[1 + nv]``.  ``run_max`` is the running ts maximum before
    the slice; returns ``(ts_min, ts_max, running maximum at the slice's
    last row)``.  Native only."""
    if take < 1 or (rec0 + take) * frame_record_bytes(nv) > raw.size:
        raise ValueError(f"records [{rec0}, {rec0 + take}) beyond a "
                         f"buffer of {raw.size} bytes")
    words = [key_words] + [1] * nv + [2]
    if len(lane_off) != nv + 2 or dst.dtype != np.uint32 or any(
            o < 0 or o + w * take > dst.size
            for o, w in zip(lane_off.tolist(), words)):
        raise ValueError("a lane runs past the staging buffer")
    _count("pack_frames")
    out = np.empty(3, np.int64)
    lib().wf_pack_frames(_ptr(raw), nv, rec0, take, _ptr(dst),
                         _ptr(lane_off), key_words, run_max, _ptr(out))
    return int(out[0]), int(out[1]), int(out[2])


def parse_csv(buf: bytes, nv: int, max_records: int = 2 ** 62):
    """Parse "key,ts,v0[,v1...]\\n" lines into columns.  Returns (keys,
    tss, vals[n, nv], consumed_bytes); the fallback is
    ``io/parse.parse_csv``."""
    L = lib()
    if L is None:
        from windflow_tpu_torch.io import parse
        return parse.parse_csv(buf, nv, max_records)
    _count("parse_csv")
    cap = min(max_records, buf.count(b"\n") + 1)
    keys = np.empty(cap, np.int64)
    tss = np.empty(cap, np.int64)
    vals = np.empty((cap, nv), np.float64)
    consumed = np.zeros(1, np.int64)
    raw = np.frombuffer(buf, np.uint8)
    n = L.wf_parse_csv(_ptr(raw), len(buf), nv, _ptr(keys), _ptr(tss),
                       _ptr(vals), cap, _ptr(consumed))
    return keys[:n].copy(), tss[:n].copy(), vals[:n].copy(), \
        int(consumed[0])


def min_watermark(channel_wms: np.ndarray, wm_none: int) -> int:
    """Min over channel maxima; wm_none if any channel is still unset."""
    channel_wms = np.ascontiguousarray(channel_wms, np.int64)
    L = lib()
    if L is not None:
        _count("min_watermark")
        return int(L.wf_min_watermark(_ptr(channel_wms), len(channel_wms),
                                      wm_none))
    if (channel_wms == wm_none).any() or len(channel_wms) == 0:
        return wm_none
    return int(channel_wms.min())
