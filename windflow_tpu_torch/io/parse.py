"""Bulk ingest parsers in numpy: the fallback and plain twin of the
native parsers (``windflow_tpu_torch/native``: ``wf_parse_frames``,
``wf_parse_csv``), which ``io/frames.py`` goes through.

Frame wire format: little-endian ``int64 key, int64 ts, nv × float64``
per record.  CSV: ``key,ts,v0[,v1...]`` lines; malformed lines are
skipped.  Both return ``(keys int64[n], tss int64[n], vals
float64[n, nv], consumed_bytes)``: a trailing partial record is left
unconsumed for the caller to carry into the next chunk.
"""

from __future__ import annotations

import numpy as np


def frame_record_bytes(nv: int) -> int:
    """Bytes of one frame record with ``nv`` values."""
    return 16 + 8 * nv


def frame_dtype(nv: int) -> np.dtype:
    """The structured dtype of one frame record."""
    return np.dtype([("k", "<i8"), ("t", "<i8"), ("v", "<f8", (nv,))])


def parse_frames(buf: bytes, nv: int, max_records: int = 2 ** 62):
    """Parse binary frame records through one structured ``np.frombuffer``
    view (no per-record work).  Returns ``(keys, tss, vals[n, nv],
    consumed_bytes)``."""
    rec = frame_record_bytes(nv)
    n = min(len(buf) // rec, max_records)
    view = np.frombuffer(buf, frame_dtype(nv), count=n)
    return (np.ascontiguousarray(view["k"]), np.ascontiguousarray(view["t"]),
            np.ascontiguousarray(view["v"]).reshape(n, nv), n * rec)


def parse_csv(buf: bytes, nv: int, max_records: int = 2 ** 62):
    """Parse ``key,ts,v0[,v1...]\\n`` lines; a line without its newline is
    left unconsumed, a malformed one is skipped.  Returns ``(keys, tss,
    vals[n, nv], consumed_bytes)``."""
    keys, tss, rows = [], [], []
    consumed = 0
    for line in buf.split(b"\n")[:-1]:
        end = consumed + len(line) + 1
        if len(keys) >= max_records:
            break
        consumed = end
        parts = line.split(b",")
        if len(parts) != 2 + nv:
            continue
        try:
            k, t = int(parts[0]), int(parts[1])
            vs = [float(x) for x in parts[2:]]
        except ValueError:
            continue
        keys.append(k)
        tss.append(t)
        rows.append(vs)
    return (np.array(keys, np.int64), np.array(tss, np.int64),
            np.array(rows, np.float64).reshape(len(keys), nv), consumed)
