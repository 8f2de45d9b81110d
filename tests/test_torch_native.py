"""The port's native host runtime (``windflow_tpu_torch/native``: its own
copies of ``wf_host.cpp`` and ``wf_kv.cpp``, built with g++ at first
use) against the JAX package's (``tests/test_native_io.py``,
``tests/test_persistent.py:89-191``), on the CPU.

Twins of the fifteen native-IO tests: the keyby hash and partition, the
frame and CSV parsers (partial frames, malformed and long lines, empty
fields), the watermark fold and the FrameSource graphs, each against the
JAX package's functions on the same seeded bytes, exactly and with
dtypes.  The library must be available (this container and the card
host have g++): a fallback nobody asked for fails here, and the graph
tests check that the native parsers were actually entered
(``native.call_counts``).  Beyond the twins: the wide fan-in watermark
fold (more than 8 channels, through ``wf_min_watermark``), the atomic
publish of concurrent builds, and the KV parity fuzz with the four
backends (the port's and JAX's, native and Python) recovering every
torn or corrupted image identically, and stores crossed between them.
"""

import ctypes
import os
import struct
import threading

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import native as jnative
from windflow_tpu.io import FrameSource as JFrameSource
from windflow_tpu_torch import native
from windflow_tpu_torch.io import parse

torch.set_num_threads(1)


def frames_bytes(records, nv=1):
    out = b""
    for k, ts, *vs in records:
        out += struct.pack("<qq" + "d" * nv, k, ts, *vs)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


# ---------------------------------------------------------------------------
# the library and its wrappers
# ---------------------------------------------------------------------------

def test_native_builds_and_loads():
    assert native.is_available(), native.build_error()
    assert native.build_error() is None
    path = native.so_path()
    assert os.path.exists(path)
    # built from the port's own sources into its git-ignored build dir
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.sep + "windflow_tpu_torch" + os.sep in path
    assert "libwfhost" in os.path.basename(native.lib()._name)


def test_hash_native_matches_numpy():
    L = native.lib()
    keys = np.array([0, 1, 2, -1, 123456789, 2 ** 62], np.int64)
    py = native.hash64(keys)
    np.testing.assert_array_equal(py, jnative.hash64(keys))
    for i, k in enumerate(keys):
        assert L.wf_hash64(int(k)) == int(py[i])


def test_keyby_partition_parity_and_counts():
    keys = np.random.default_rng(0).integers(-100, 100, 1000)
    for ndest in (1, 3, 8):
        native.reset_call_counts()
        dests, counts = native.keyby_partition(keys, ndest)
        assert native.call_counts() == {"keyby_partition": 1}
        exp = (native.hash64(keys.astype(np.int64))
               % np.uint64(ndest)).astype(np.int32)
        np.testing.assert_array_equal(dests, exp)
        np.testing.assert_array_equal(
            counts, np.bincount(exp, minlength=ndest))
        _same((dests, counts), jnative.keyby_partition(keys, ndest))


def test_parse_frames_roundtrip_and_carry():
    recs = [(i % 5, 1000 + i, float(i), float(-i)) for i in range(97)]
    buf = frames_bytes(recs, nv=2)
    buf_partial = buf + b"\x01\x02\x03"
    native.reset_call_counts()
    got = native.parse_frames(buf_partial, nv=2)
    assert native.call_counts() == {"parse_frames": 1}
    keys, tss, vals, consumed = got
    assert consumed == len(buf) and len(keys) == 97
    np.testing.assert_array_equal(keys, [r[0] for r in recs])
    np.testing.assert_array_equal(tss, [r[1] for r in recs])
    np.testing.assert_array_equal(vals[:, 0], [r[2] for r in recs])
    np.testing.assert_array_equal(vals[:, 1], [r[3] for r in recs])
    _same(got, jnative.parse_frames(buf_partial, nv=2))
    _same(got, parse.parse_frames(buf_partial, 2))    # the numpy twin


CSV_CASES = {
    "malformed": (b"1,10,2.5\n2,20,3.5\nbogus line\n3,30,4.5\n4,40", 1),
    "empty_field": (b"5,50,\n6,60,7.5\n", 1),
    "long_lines": ((("7,70," + ",".join(f"{1.5:.10f}" for _ in range(60))
                     + "\n") * 3).encode(), 60),
    "empty_ts": (b"1,,2.5\n2,20,3.5\n", 1),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_parse_csv_cases(case):
    """tests/test_native_io.py's four CSV tests: malformed lines skipped
    (a partial last line left unconsumed), an empty value field skipped
    without stealing the next line, lines longer than any scratch buffer,
    an empty ts field skipped; the native parser, the numpy twin and the
    JAX package's native parser agree exactly."""
    buf, nv = CSV_CASES[case]
    native.reset_call_counts()
    got = native.parse_csv(buf, nv=nv)
    assert native.call_counts() == {"parse_csv": 1}
    _same(got, jnative.parse_csv(buf, nv=nv))
    _same(got, parse.parse_csv(buf, nv))
    keys, tss, vals, consumed = got
    if case == "malformed":
        np.testing.assert_array_equal(keys, [1, 2, 3])
        np.testing.assert_array_equal(vals[:, 0], [2.5, 3.5, 4.5])
        assert buf[consumed:] == b"4,40"
    elif case == "empty_field":
        np.testing.assert_array_equal(keys, [6])
        np.testing.assert_array_equal(tss, [60])
    elif case == "long_lines":
        assert len(buf) > 3 * 512 and vals.shape == (3, nv)
        assert consumed == len(buf)
    else:
        np.testing.assert_array_equal(keys, [2])
        np.testing.assert_array_equal(tss, [20])


def test_min_watermark():
    WM = -1
    for mod in (native, jnative):
        assert mod.min_watermark(np.array([5, 3, 9], np.int64), WM) == 3
        assert mod.min_watermark(np.array([5, WM, 9], np.int64), WM) == WM
        assert mod.min_watermark(np.array([], np.int64), WM) == WM


def test_wide_fan_in_folds_natively():
    """A collector of more than 8 channels folds through the native
    ``wf_min_watermark`` over its open channels' slots (a closed
    channel's unset slot does not hold the frontier down); its frontier
    equals the JAX collector's message for message."""
    from windflow_tpu.parallel.collectors import WatermarkCollector as JWC
    from windflow_tpu_torch.batch import Punctuation
    from windflow_tpu_torch.parallel.collectors import WatermarkCollector
    from windflow_tpu.batch import Punctuation as JPunct
    n = 12
    tc, jc = WatermarkCollector(n), JWC(n)
    rng = np.random.default_rng(5)
    native.reset_call_counts()
    jc.on_channel_eos(3)
    tc.on_channel_eos(3)
    sent = 0
    for _ in range(200):
        ch = int(rng.integers(0, n))
        if ch == 3:
            continue
        wm = int(rng.integers(0, 10 ** 6))
        (t,) = tc.on_message(ch, Punctuation(wm))
        (j,) = jc.on_message(ch, JPunct(wm))
        assert t.watermark == j.watermark
        sent += 1
    assert t.watermark != -1                # every open channel heard
    assert native.call_counts()["min_watermark"] == sent
    small = WatermarkCollector(4)
    native.reset_call_counts()
    small.on_message(0, Punctuation(5))
    assert "min_watermark" not in native.call_counts()


def test_keyby_placement_agrees_across_paths():
    """The record path (``splitmix64_int``), the native columnar path and
    the card's placement (``place_torch``, here on CPU tensors) place
    every key on the same replica, as JAX's do."""
    from windflow_tpu.parallel.emitters import splitmix64_int as jsplit
    from windflow_tpu_torch.parallel.emitters import (place_torch,
                                                      splitmix64_int)
    rnd = np.random.default_rng(3)
    keys = rnd.integers(-2 ** 31, 2 ** 31, 257).astype(np.int64)
    for n in (2, 3, 7):
        native_dest, _ = native.keyby_partition(keys, n)
        py_dest = np.array([splitmix64_int(int(k)) % n for k in keys])
        dev_dest = place_torch(torch.from_numpy(keys).to(torch.int32),
                               n).numpy()
        assert np.array_equal(native_dest, py_dest)
        assert np.array_equal(native_dest, dev_dest.astype(np.int64))
        assert np.array_equal(py_dest,
                              [jsplit(int(k)) % n for k in keys])


def test_concurrent_builds_publish_atomically(tmp_path, monkeypatch):
    """Four builders at once into an empty build directory (pytest-xdist
    workers at first use): each compiles privately and publishes with one
    ``os.replace``, so every one of them ends with a loadable library and
    no temporary directory is left behind."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    final = native.so_path()
    errs = []

    def one():
        try:
            native._build(final)
        except Exception as e:  # noqa: BLE001 (collected, asserted below)
            errs.append(e)
    ts = [threading.Thread(target=one) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert os.listdir(tmp_path / "b") == [os.path.basename(final)]
    assert ctypes.CDLL(final).wf_hash64 is not None


# ---------------------------------------------------------------------------
# FrameSource graphs: the native parsers feed the columnar staging
# ---------------------------------------------------------------------------

def _run_graph(pkg, build):
    g = pkg.PipeGraph("native_io", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT,
                      config=wt.Config(device="cpu") if pkg is wt else None)
    build(g)
    native.reset_call_counts()
    g.run()
    return native.call_counts()


def _fs(pkg, *a, **kw):
    return (JFrameSource if pkg is wf else wt.FrameSource)(*a, **kw)


def test_frame_source_csv_without_trailing_newline():
    blob = b"1,10,2.5\n2,20,3.5"
    out = {}
    for pkg in (wf, wt):
        got = out[pkg] = []
        calls = _run_graph(pkg, lambda g: g.add_source(_fs(
            pkg, lambda: iter([blob]), nv=1, fmt="csv",
            output_batch_size=4)).add_sink(pkg.Sink_Builder(
                lambda t: got.append((t["key"], t["v0"])) if t else None)
            .build()))
    assert calls.get("parse_csv", 0) >= 2     # the chunk, then the carry
    assert sorted(out[wt]) == sorted(out[wf]) == [(1, 2.5), (2, 3.5)]


@pytest.mark.parametrize("fmt", ["frames", "csv"])
def test_frame_source_to_device_pipeline(fmt):
    """bytes → FrameSource → MapGPU → keyed ReduceGPU → Sink, records
    split across chunk boundaries, against the oracle and the JAX run
    (integer-valued sums: exact)."""
    n, n_keys = 600, 7
    recs = [(i % n_keys, 1_000_000 + i, float(i)) for i in range(n)]
    blob = frames_bytes(recs) if fmt == "frames" \
        else b"".join(b"%d,%d,%f\n" % r for r in recs)

    def chunks():
        for lo in range(0, len(blob), 997):
            yield blob[lo:lo + 997]

    out = {}
    for pkg in (wf, wt):
        sums = out[pkg] = {}

        def sink(t, ctx=None, sums=sums):
            if t is not None:
                sums[int(t["key"])] = sums.get(int(t["key"]), 0) + t["v0"]
        mb = wf.MapTPU_Builder if pkg is wf else wt.MapGPU_Builder
        rb = wf.ReduceTPU_Builder if pkg is wf else wt.ReduceGPU_Builder

        def build(g, pkg=pkg, mb=mb, rb=rb, sink=sink):
            mp = g.add_source(_fs(pkg, chunks, nv=1, fmt=fmt,
                                  output_batch_size=64))
            mp.add(mb(lambda t: {"key": t["key"], "v0": t["v0"] * 2.0})
                   .build())
            mp.add(rb(lambda a, b: {"key": a["key"], "v0": a["v0"] + b["v0"]})
                   .withKeyBy(lambda t: t["key"]).build())
            mp.add_sink(pkg.Sink_Builder(sink).build())
        calls = _run_graph(pkg, build)
    assert calls.get("parse_" + fmt.rstrip("s").replace("frame", "frames"),
                     calls.get("parse_csv", 0)) > 0
    exp = {}
    for k, _, v in recs:
        exp[k] = exp.get(k, 0) + 2.0 * v
    assert out[wt] == out[wf] == exp


def test_frame_source_to_host_sink_fallback_path(monkeypatch):
    """Columns explode to per-tuple records for a host sink, and the
    numpy parser path (the library off, ``WF_TPU_NO_NATIVE=1``) agrees
    with the native one and with JAX's."""
    n = 100
    recs = [(i % 3, 10 + i, float(i)) for i in range(n)]
    blob = frames_bytes(recs)

    def run(pkg):
        total = [0.0]
        calls = _run_graph(pkg, lambda g: g.add_source(_fs(
            pkg, lambda: iter([blob]), nv=1, output_batch_size=16))
            .add_sink(pkg.Sink_Builder(
                lambda t: total.__setitem__(0, total[0] + t["v0"])
                if t else None).build()))
        return total[0], calls

    exp = sum(r[2] for r in recs)
    got, calls = run(wt)
    assert got == exp and calls.get("parse_frames", 0) >= 1
    assert run(wf)[0] == exp
    monkeypatch.setenv("WF_TPU_NO_NATIVE", "1")
    assert not native.is_available()
    got, calls = run(wt)
    assert got == exp and calls == {}


def test_columnar_sink_end_to_end():
    n, n_keys = 500, 5
    recs = [(i % n_keys, 1_000_000 + i, float(i)) for i in range(n)]
    blob = frames_bytes(recs)

    def run(pkg, columnar):
        got = {"sum": 0.0, "rows": 0, "batches": 0, "ts_sum": 0}

        def col_sink(c, ctx=None):
            if c is None:
                return
            assert isinstance(c, pkg.SinkColumns)
            assert isinstance(c.cols["v0"], np.ndarray)
            got["sum"] += float(c.cols["v0"].sum())
            got["rows"] += len(c)
            got["batches"] += 1
            got["ts_sum"] += int(c.tss.sum())

        def rec_sink(t, ctx=None):
            if t is not None:
                got["sum"] += t["v0"]
                got["rows"] += 1

        mb = wf.MapTPU_Builder if pkg is wf else wt.MapGPU_Builder
        b = pkg.Sink_Builder(col_sink if columnar else rec_sink)
        if columnar:
            b = b.withColumnarSink()
        _run_graph(pkg, lambda g: g.add_source(_fs(
            pkg, lambda: iter([blob]), nv=1, fmt="frames",
            output_batch_size=64)).add(mb(
                lambda t: {"key": t["key"], "v0": t["v0"] * 2.0}).build())
            .add_sink(b.build()))
        return got

    col, rec, jcol = run(wt, True), run(wt, False), run(wf, True)
    assert col["rows"] == rec["rows"] == n
    assert col["sum"] == rec["sum"] == jcol["sum"]
    assert col["batches"] <= -(-n // 64) + 1
    assert col["ts_sum"] == jcol["ts_sum"] == sum(r[1] for r in recs)


def test_chunk_spanning_batches_do_not_fire_ahead():
    """One parse chunk spanning many staged batches: head batches do not
    carry the chunk's watermark, so TB windows never fire ahead of
    unplaced data (ordered stream: exact, zero late), as in JAX."""
    n, n_keys = 1000, 4
    TWIN, TSLIDE = 16_000, 4_000
    recs = [(i % n_keys, i * 1000, float(i)) for i in range(n)]
    blob = frames_bytes(recs)
    res = {}
    for pkg in (wf, wt):
        got = {}
        wb = wf.Ffat_WindowsTPU_Builder if pkg is wf \
            else wt.Ffat_WindowsGPU_Builder
        op = (wb(lambda t: t["v0"], lambda a, b: a + b)
              .withTBWindows(TWIN, TSLIDE).withKeyBy(lambda t: t["key"])
              .withMaxKeys(n_keys).build())
        snk = pkg.Sink_Builder(
            lambda r, got=got: got.__setitem__(
                (int(r["key"]), int(r["wid"])), float(r["value"]))
            if r is not None else None).build()
        _run_graph(pkg, lambda g, pkg=pkg, op=op, snk=snk: g.add_source(
            _fs(pkg, lambda: iter([blob]), nv=1, fmt="frames",
                output_batch_size=64)).add(op).add_sink(snk))
        st = op.dump_stats()
        assert st["Late_tuples_dropped"] == 0
        assert st["Pane_cells_evicted"] == 0
        res[pkg] = got
    exp = {}
    per_key = {}
    for k, ts, v in recs:
        per_key.setdefault(k, []).append((ts, v))
    for k, pts in per_key.items():
        wids = set()
        for ts, _ in pts:
            first = max(0, -(-(ts - TWIN + 1) // TSLIDE))
            wids.update(range(first, ts // TSLIDE + 1))
        for w in wids:
            vals = [v for ts, v in pts
                    if w * TSLIDE <= ts < w * TSLIDE + TWIN]
            if vals:
                exp[(k, w)] = sum(vals)
    assert res[wt] == res[wf] == exp


# ---------------------------------------------------------------------------
# the KV store: four backends, one format
# ---------------------------------------------------------------------------

def _backends():
    from windflow_tpu.persistent import kv as jkv
    from windflow_tpu_torch.persistent import kv as tkv
    assert jnative.is_available() and native.is_available()
    return {"port_native": tkv._NativeKV, "port_py": tkv._PyKV,
            "jax_native": jkv._NativeKV, "jax_py": jkv._PyKV}


def _recover_all(tmp_path, raw, tag):
    """Open one byte image under every backend (each its own copy: the
    open-time recovery truncates in place): the live maps and the
    recovered log lengths."""
    out = {}
    for name, cls in _backends().items():
        p = str(tmp_path / f"{name}_{tag}")
        with open(p, "wb") as f:
            f.write(raw)
        kv = cls(p)
        out[name] = ({k: kv.get(k) for k in kv.keys()}, kv.log_bytes())
        kv.close(delete_db=True)
    return out


def _image(tmp_path, cls, ops):
    path = str(tmp_path / f"img_{cls.__module__}_{cls.__name__}")
    kv = cls(path)
    for op, *a in ops:
        getattr(kv, op)(*a)
    kv.flush()
    kv.close()
    with open(path, "rb") as f:
        raw = f.read()
    os.unlink(path)
    return raw


TORN_OPS = [("put", b"a", b"1"), ("put", b"bb", b"x" * 37),
            ("put", b"a", b"2"), ("delete", b"bb"),
            ("put", b"ccc", bytes(range(64))), ("put", b"d" * 9, b"")]


def test_kv_crash_consistency_fuzz_four_backends(tmp_path):
    """Every backend writes the same byte image, and every torn prefix
    (a crash mid-append at any byte) recovers the same live set at the
    same point under all four."""
    images = {name: _image(tmp_path, cls, TORN_OPS)
              for name, cls in _backends().items()}
    raw = images["jax_py"]
    assert all(img == raw for img in images.values())
    assert len(raw) < 400
    for cut in range(len(raw) + 1):
        got = _recover_all(tmp_path, raw[:cut], cut)
        first = got["jax_native"]
        assert all(v == first for v in got.values()), (cut, got)
        assert first[1] <= cut
    assert _recover_all(tmp_path, raw, "full")["port_native"][0] == {
        b"a": b"2", b"ccc": bytes(range(64)), b"d" * 9: b""}


def test_kv_corruption_fuzz_four_backends(tmp_path):
    raw = bytearray(_image(tmp_path, _backends()["port_native"],
                           [("put", b"k1", b"alpha"),
                            ("put", b"k2", b"beta" * 8),
                            ("delete", b"k1"), ("put", b"k3", b"gamma")]))
    for off in range(len(raw)):
        bad = bytes(raw[:off]) + bytes([raw[off] ^ 0xFF]) \
            + bytes(raw[off + 1:])
        got = _recover_all(tmp_path, bad, f"c{off}")
        first = got["jax_native"]
        assert all(v == first for v in got.values()), (off, got)


def test_kv_stores_cross_backends_and_packages(tmp_path):
    """A store written (and auto-compacted) by the port's ``LogKV`` on
    the native backend reopens under JAX's Python and native backends,
    and a JAX store under the port's; ``LogKV`` picks the native backend
    whenever the library is there, and counts its opens."""
    from windflow_tpu.persistent.kv import LogKV as JLogKV
    from windflow_tpu.persistent.kv import _PyKV as JPy
    from windflow_tpu_torch.persistent.kv import LogKV, _NativeKV, _PyKV
    path = str(tmp_path / "store")
    native.reset_call_counts()
    kv = LogKV(path, min_compact_bytes=256)
    assert isinstance(kv._kv, _NativeKV)
    want = {}
    for i in range(400):
        k, v = b"k%d" % (i % 37), b"v%d" % i
        kv.put(k, v)
        want[k] = v
    kv.delete(b"k5")
    del want[b"k5"]
    kv.close()
    assert native.call_counts()["kv_open"] == 1
    assert native.call_counts()["kv_put"] == 400
    for cls in (JPy, JLogKV, _PyKV):
        other = cls(path)
        assert {k: other.get(k) for k in other.keys()} == want
        other.close()
    back = JLogKV(path)
    back.put(b"k5", b"from_jax")
    back.close()
    mine = LogKV(path)
    assert mine.get(b"k5") == b"from_jax" and len(mine) == len(want) + 1
    mine.close(delete_db=True)
