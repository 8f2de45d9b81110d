"""Columnar ingest of the port (windflow_tpu_torch/io, the columnar routes
of parallel/emitters.DeviceStageEmitter) against the JAX package.

Seeded numpy input goes through both packages:

* the frame and CSV parsers against ``windflow_tpu.native`` (exact, with
  dtypes), at one and three values a record, a partial trailing frame,
  malformed CSV lines and CSV without its final newline;
* the slice's graphs at small size through both ``PipeGraph.run()``s
  under EVENT time: FrameSource → MapGPU | FilterGPU → keyed FFAT count
  windows (both combiners; chunks that split records, and batches that
  span chunks or share one), and the YSB shape (FrameSource → FilterGPU |
  MapGPU ad → campaign → tumbling time windows), record for record with
  dtypes on integer-valued data;
* the staging emitter on its own: every staged batch's lanes, size,
  watermark, frontier and timestamp extrema, on a stream with per-row
  frontiers, on a mixed record-and-columnar stream, and on a lane that is
  not packable (the chunk route);
* the frame source's direct route (frames written straight into the
  packed staging buffer) against the column route fed the numpy
  parser's columns of the same bytes, buffer for buffer and bit for bit
  (keys of every width, NaN and infinities, out-of-order ts, records and
  batches split across chunks, a key width that changes), and where the
  route engages: frames into a plain staging emitter only, with the same
  results as the column route everywhere;
* the DeviceSource families of tests/test_device_source.py;
* the declared floating-point sum (CB and TB): the same bits on two runs,
  within rtol 1e-5 of the JAX package (its sequential scatter-add and the
  port's fixed doubling tree differ by reassociation only).
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import native
from windflow_tpu.io import FrameSource as JFrameSource
from windflow_tpu_torch.io import parse

# one intra-op thread: toy sizes beside other test workers
torch.set_num_threads(1)


def _jax_cfg():
    return dataclasses.replace(wf.default_config,
                               punctuation_interval_usec=10 ** 12)


def _port_cfg(**kw):
    return wt.Config(device="cpu", punctuation_interval_usec=10 ** 12, **kw)


def _cfg(pkg):
    return _port_cfg() if pkg is wt else _jax_cfg()


def _frames(keys, tss, vals):
    rec = np.empty(len(keys), dtype=[("k", "<i8"), ("t", "<i8"),
                                     ("v", "<f8", (vals.shape[1],))])
    rec["k"], rec["t"], rec["v"] = keys, tss, vals
    return rec.tobytes()


def _chunks(blob, step):
    def gen():
        for lo in range(0, len(blob), step):
            yield blob[lo:lo + step]
    return gen


def _builders(pkg):
    if pkg is wt:
        return (wt.MapGPU_Builder, wt.FilterGPU_Builder,
                wt.Ffat_WindowsGPU_Builder, wt.FrameSource)
    return (wf.MapTPU_Builder, wf.FilterTPU_Builder,
            wf.Ffat_WindowsTPU_Builder, JFrameSource)


def _columns(batches):
    """Concatenated columnar sink batches: {name: array} plus tss."""
    names = list(batches[0].cols)
    cols = {n: np.concatenate([np.asarray(b.cols[n]) for b in batches])
            for n in names}
    return cols, np.concatenate([np.asarray(b.tss) for b in batches])


def _same_records(a, b, sort_by=("key", "wid")):
    """Two packages' columnar records: same names, dtypes and values, in
    (key, wid) order."""
    (ca, ta), (cb, tb) = a, b
    assert list(ca) == list(cb)
    oa = np.lexsort([ca[n] for n in reversed(sort_by)])
    ob = np.lexsort([cb[n] for n in reversed(sort_by)])
    for n in ca:
        assert ca[n].dtype == cb[n].dtype, n
        np.testing.assert_array_equal(ca[n][oa], cb[n][ob], err_msg=n)
    np.testing.assert_array_equal(ta[oa], tb[ob])


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nv", [1, 3])
def test_parse_frames_matches_jax(nv):
    rng = np.random.default_rng(nv)
    n = 301
    keys = rng.integers(-2 ** 40, 2 ** 40, n)
    tss = rng.integers(0, 2 ** 50, n)
    vals = rng.standard_normal((n, nv))
    blob = _frames(keys, tss, vals) + b"\x01\x02\x03"   # a partial frame
    got = parse.parse_frames(blob, nv)
    want = native.parse_frames(blob, nv)
    assert got[3] == want[3] == n * parse.frame_record_bytes(nv)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], vals)


@pytest.mark.parametrize("nv", [1, 3])
def test_parse_csv_matches_jax(nv):
    rng = np.random.default_rng(10 + nv)
    lines = []
    for i in range(40):
        vs = ",".join(repr(float(x)) for x in rng.standard_normal(nv))
        lines.append(f"{i % 7},{1000 + i},{vs}")
    lines[5] = "bogus line"
    lines[9] = f"3,,{','.join(['1.5'] * nv)}"          # empty ts
    lines[13] = "4,40," + ",".join(["2.5"] * (nv - 1)) + ","  # empty value
    blob = ("\n".join(lines) + "\n" + "8,80").encode()  # no final newline
    got = parse.parse_csv(blob, nv)
    want = native.parse_csv(blob, nv)
    assert got[3] == want[3] and blob[got[3]:] == b"8,80"
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_frame_source_csv_without_trailing_newline():
    blob = b"1,10,2.5\n2,20,3.5"
    out = {}
    for pkg in (wf, wt):
        got = []
        FS = wt.FrameSource if pkg is wt else JFrameSource
        g = pkg.PipeGraph("csv_tail", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT, config=_cfg(pkg))
        g.add_source(FS(lambda: iter([blob[:7], blob[7:]]), nv=1, fmt="csv",
                        output_batch_size=4)) \
            .add_sink(pkg.Sink_Builder(lambda t: got.append(
                (t["key"], t["v0"])) if t else None).build())
        g.run()
        out[pkg] = sorted(got)
    assert out[wt] == out[wf] == [(1, 2.5), (2, 3.5)]


# ---------------------------------------------------------------------------
# graph (i): FrameSource → Map | Filter → keyed FFAT CB → columnar sink
# ---------------------------------------------------------------------------

CB_CAP, CB_KEYS, CB_N = 256, 16, 3000


def _cb_data(seed, floats=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, CB_KEYS, CB_N)
    tss = np.arange(CB_N, dtype=np.int64) * 7
    vals = (rng.standard_normal((CB_N, 1)) if floats
            else rng.integers(-100, 101, (CB_N, 1)).astype(np.float64))
    return keys, tss, vals


def _cb_graph(pkg, blob, step, sum_combiner, sink):
    MB, FB, WB, FS = _builders(pkg)
    src = FS(_chunks(blob, step), nv=1, fmt="frames",
             output_batch_size=CB_CAP)
    wb = (WB(lambda t: t["v0"], lambda a, b: a + b).withCBWindows(64, 16)
          .withKeyBy(lambda t: t["key"]).withMaxKeys(CB_KEYS))
    if sum_combiner:
        wb = wb.withSumCombiner()
    g = pkg.PipeGraph("frames_cb", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT, config=_cfg(pkg))
    pipe = g.add_source(src)
    pipe.add(MB(lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0})
             .build())
    pipe.chain(FB(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(wb.build()).add_sink(pkg.Sink_Builder(sink)
                                  .withColumnarSink(defer=4).build())
    return g, src


def _run_cb(pkg, blob, step, sum_combiner):
    got = []
    g, src = _cb_graph(pkg, blob, step, sum_combiner,
                       lambda c: got.append(c) if c is not None else None)
    g.run()
    return _columns(got), src


@pytest.mark.parametrize("sum_combiner", [False, True])
@pytest.mark.parametrize("step", [997, 20_000])
def test_frame_source_cb_graph_matches_jax(sum_combiner, step):
    """997-byte chunks split records and batches span chunks; 20,000-byte
    chunks hold several batches each."""
    keys, tss, vals = _cb_data(1)
    blob = _frames(keys, tss, vals)
    a, _ = _run_cb(wf, blob, step, sum_combiner)
    b, src = _run_cb(wt, blob, step, sum_combiner)
    _same_records(a, b)
    assert b[0]["key"].dtype == np.int32
    # the oracle: per-key CB windows of 64 sliding by 16
    keep = (keys & 7) != 7
    v = vals[keep, 0].astype(np.float32) * np.float32(1.5) + np.float32(1)
    want = {}
    for k in np.unique(keys[keep]):
        vk = v[keys[keep] == k].astype(np.float64)
        for w, s in enumerate(range(0, len(vk), 16)):
            want[(int(k), w)] = vk[s:s + 64].sum()
    cols = b[0]
    assert {(int(k), int(w)): float(x) for k, w, x in
            zip(cols["key"], cols["wid"], cols["value"])} == want
    # the columnar route only: every batch staged packed
    em = src.replicas[0].emitter
    assert em.packed_batches == -(-CB_N // CB_CAP)
    assert em.record_batches == em.chunked_batches == 0


# ---------------------------------------------------------------------------
# graph (ii): the YSB shape on a FrameSource
# ---------------------------------------------------------------------------

def _ysb_run(pkg, blob, table, sum_combiner, step=5000, cap=512):
    MB, FB, WB, FS = _builders(pkg)
    dev_table = torch.from_numpy(table) if pkg is wt else None
    if pkg is wt:
        def campaign(e):
            return {"campaign": dev_table[e["key"].long()], "one": 1}
    else:
        import jax.numpy as jnp
        jtable = jnp.asarray(table)

        def campaign(e):
            return {"campaign": jtable[e["key"]], "one": 1}
    got = []
    win = (WB(lambda e: e["one"], lambda a, b: a + b)
           .withTBWindows(10_000_000, 10_000_000)
           .withKeyBy(lambda e: e["campaign"]).withMaxKeys(10))
    if sum_combiner:
        win = win.withSumCombiner()
    win = win.build()
    g = pkg.PipeGraph("frames_ysb", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT, config=_cfg(pkg))
    pipe = g.add_source(FS(_chunks(blob, step), nv=1, fmt="frames",
                           output_batch_size=cap))
    pipe.add(FB(lambda e: e["v0"] == 1.0).build())
    pipe.chain(MB(campaign).build())
    pipe.add(win).add_sink(pkg.Sink_Builder(
        lambda c: got.append(c) if c is not None else None)
        .withColumnarSink().build())
    g.run()
    st = win.dump_stats()
    return _columns(got), [st[k] for k in (
        "Late_tuples_dropped", "Pane_cells_evicted",
        "Windows_dropped_on_overflow")]


@pytest.mark.parametrize("sum_combiner", [False, True])
def test_frame_source_ysb_graph_matches_jax(sum_combiner):
    rng = np.random.default_rng(3)
    n = 4000
    table = rng.integers(0, 10, 50).astype(np.int32)
    ad = rng.integers(0, 50, n)
    etype = rng.integers(0, 3, (n, 1)).astype(np.float64)
    tss = np.arange(n, dtype=np.int64) * 16_000     # ~6 windows
    blob = _frames(ad, tss, etype)
    a, sa = _ysb_run(wf, blob, table, sum_combiner)
    b, sb = _ysb_run(wt, blob, table, sum_combiner)
    _same_records(a, b)
    assert sa == sb == [0, 0, 0]
    views = etype[:, 0] == 1
    want = {}
    for c, w in zip(table[ad[views]], tss[views] // 10_000_000):
        want[(int(c), int(w))] = want.get((int(c), int(w)), 0) + 1
    cols = b[0]
    assert {(int(k), int(w)): int(v) for k, w, v in
            zip(cols["key"], cols["wid"], cols["value"])} == want


# ---------------------------------------------------------------------------
# the staging emitter on its own
# ---------------------------------------------------------------------------

class _Capture:
    def __init__(self):
        self.msgs = []

    def receive(self, ch, msg):
        self.msgs.append(msg)


def _emitters(cap):
    from windflow_tpu.parallel.emitters import DeviceStageEmitter as JE
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter as TE
    jc, tc = _Capture(), _Capture()
    return (JE([(jc, 0)], cap), jc), \
        (TE([(tc, 0)], cap, torch.device("cpu")), tc)


def _batch_view(db):
    """(lanes, ts, size, watermark, frontier, ts_min, ts_max) of a staged
    batch's valid lanes, either package."""
    valid = np.asarray(db.valid)
    lanes = {k: np.asarray(v)[valid] for k, v in db.payload.items()}
    return (lanes, np.asarray(db.ts)[valid], int(valid.sum()), db.watermark,
            db.frontier, db.ts_min, db.ts_max)


def _same_batches(jc, tc):
    assert len(jc.msgs) == len(tc.msgs) > 0
    for jb, tb in zip(jc.msgs, tc.msgs):
        j, t = _batch_view(jb), _batch_view(tb)
        assert list(j[0]) == list(t[0])
        for k in j[0]:
            assert j[0][k].dtype == t[0][k].dtype, k
            np.testing.assert_array_equal(j[0][k], t[0][k])
        np.testing.assert_array_equal(j[1], t[1])
        assert j[2:] == t[2:]


def _chunk_stream(rng, n_chunks, row_wms):
    """Columnar chunks of random sizes (some larger than a batch), event
    times out of order, with a per-row frontier or a chunk-level one."""
    out, t0, wm = [], 0, -1
    for _ in range(n_chunks):
        m = int(rng.integers(1, 90))
        ts = t0 + rng.integers(0, 500, m).astype(np.int64)
        t0 += 300
        cols = {"key": rng.integers(0, 9, m).astype(np.int32),
                "v0": rng.standard_normal(m).astype(np.float32)}
        rw = np.maximum.accumulate(np.maximum(ts, wm))
        wm = int(rw[-1])
        out.append((cols, ts, wm, rw if row_wms else None))
    return out


@pytest.mark.parametrize("row_wms", [True, False])
def test_packed_batches_stamp_like_jax(row_wms):
    rng = np.random.default_rng(21 + row_wms)
    (je, jc), (te, tc) = _emitters(64)
    for cols, ts, wm, rw in _chunk_stream(rng, 12, row_wms):
        je.emit_columns(cols, ts, wm, row_wms=rw)
        te.emit_columns(cols, ts, wm, row_wms=rw)
    je.flush(-1)
    te.flush(-1)
    _same_batches(jc, tc)
    assert te.packed_batches == len(tc.msgs) and te.record_batches == 0


def test_mixed_record_and_columnar_stream_like_jax():
    """Records and column chunks interleaved on one emitter: batches ship
    in the same order with the same lanes and stamps."""
    rng = np.random.default_rng(5)
    (je, jc), (te, tc) = _emitters(32)
    wm = -1
    for i, (cols, ts, cwm, rw) in enumerate(_chunk_stream(rng, 10, True)):
        for e in (je, te):
            e.emit_columns(cols, ts, cwm, row_wms=rw)
        wm = max(wm, cwm)
        for j in range(int(rng.integers(1, 40))):
            item = {"key": np.int32(j % 9), "v0": np.float32(j * 0.5)}
            t = int(ts[-1]) + j
            wm = max(wm, t)
            for e in (je, te):
                e.emit(item, t, wm)
    je.flush(wm)
    te.flush(wm)
    _same_batches(jc, tc)
    assert te.record_batches > 0 and te.packed_batches > 0


def test_non_packable_lane_takes_the_chunk_route_like_jax():
    """A float16 lane is not packable: the chunks accumulate and full
    batches stage through columns_to_device."""
    rng = np.random.default_rng(9)
    (je, jc), (te, tc) = _emitters(48)
    for cols, ts, wm, rw in _chunk_stream(rng, 9, True):
        cols = dict(cols, v0=cols["v0"].astype(np.float16))
        je.emit_columns(cols, ts, wm, row_wms=rw)
        te.emit_columns(cols, ts, wm, row_wms=rw)
    je.flush(-1)
    te.flush(-1)
    _same_batches(jc, tc)
    assert te.chunked_batches == len(tc.msgs) and te.packed_batches == 0


@pytest.mark.parametrize("key_range", [(0, 2 ** 31 - 1), (2 ** 31, 2 ** 40),
                                       (-2 ** 40, 0)])
def test_frame_source_key_dtype_like_jax(key_range):
    """int32 key lanes when the keys fit, int64 beyond (a host sink sees
    the same values and types in both packages)."""
    rng = np.random.default_rng(4)
    keys = rng.integers(*key_range, 200)
    blob = _frames(keys, np.arange(200), rng.standard_normal((200, 1)))
    out = {}
    for pkg in (wf, wt):
        MB, _, _, FS = _builders(pkg)
        got = []
        g = pkg.PipeGraph("keys", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT, config=_cfg(pkg))
        g.add_source(FS(_chunks(blob, 1000), nv=1, output_batch_size=64)) \
            .add(MB(lambda t: {"key": t["key"], "v0": t["v0"]}).build()) \
            .add_sink(pkg.Sink_Builder(lambda c: got.append(c)
                                       if c is not None else None)
                      .withColumnarSink().build())
        g.run()
        out[pkg] = _columns(got)
    _same_records(out[wf], out[wt], sort_by=("key",))
    fits = key_range[1] < 2 ** 31 and key_range[0] >= -2 ** 31
    assert out[wt][0]["key"].dtype == (np.int32 if fits else np.int64)


def test_frame_source_to_host_sink_like_jax():
    """Columns explode into records for a host destination."""
    rng = np.random.default_rng(6)
    blob = _frames(rng.integers(0, 5, 150), np.arange(150),
                   rng.integers(-9, 9, (150, 2)).astype(np.float64))
    out = {}
    for pkg in (wf, wt):
        FS = wt.FrameSource if pkg is wt else JFrameSource
        got = []
        g = pkg.PipeGraph("host", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT, config=_cfg(pkg))
        g.add_source(FS(_chunks(blob, 333), nv=2, fields=["a", "b"],
                        output_batch_size=16)) \
            .add_sink(pkg.Sink_Builder(lambda t, ctx: got.append(
                (t["key"], t["a"], t["b"], ctx.get_current_timestamp()))
                if t is not None else None).build())
        g.run()
        out[pkg] = got
    assert out[wt] == out[wf] and len(out[wt]) == 150


def test_columnar_sources_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the cuda default is valid here")
    for src in (wt.FrameSource(lambda: iter([b""]), output_batch_size=8),
                wt.DeviceSource_Builder(lambda i: {}).withCapacity(8)
                .withNumBatches(1).build()):
        g = wt.PipeGraph("nocuda", config=wt.Config())
        g.add_source(src).add_sink(wt.Sink_Builder(lambda t: None).build())
        with pytest.raises(wt.WindFlowError, match="CUDA"):
            g.run()


# ---------------------------------------------------------------------------
# the direct route: frames written straight into the staging buffer
# ---------------------------------------------------------------------------

DIRECT_CAP, DIRECT_N = 64, 700
#: NaN (both signs), the infinities, a signed zero, float32 overflow and
#: underflow, and a value between two float32s
_SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 1e300,
                      1e-300, 1.0 + 2.0 ** -30])
_FIELDS = {1: ["v0"],
           5: ["event_type", "ad_type", "user_id", "page_id", "ip"]}


def _direct_blob(keys_kind, nv, ts_kind, seed):
    """Frames whose keys fit int32 (non-negative or negative), are wider
    than int32, mix signs (an int64 lane by the rule), or switch width
    twice along the stream; values with NaN, infinities and values
    float32 cannot hold; ts monotone or out of order (a few negative)."""
    rng = np.random.default_rng(seed)
    n = DIRECT_N
    lo, hi = {"int32": (0, 2 ** 31), "negative": (-2 ** 31, 0),
              "wide": (-2 ** 40, 2 ** 40), "mixed": (-5, 5),
              "switch": (0, 2 ** 31)}[keys_kind]
    keys = rng.integers(lo, hi, n)
    if keys_kind == "switch":
        keys[250:450] = rng.integers(2 ** 31, 2 ** 40, 200)
    tss = (np.arange(n, dtype=np.int64) * 3 + 10 if ts_kind == "monotone"
           else rng.integers(-50, 3 * n, n))
    vals = rng.standard_normal((n, nv)) * 1e3
    vals.flat[rng.choice(n * nv, 40, replace=False)] = \
        rng.choice(_SPECIALS, 40)
    return _frames(keys, tss, vals)


def _direct_chunks(blob, nv, chunking, seed):
    """Chunk sizes drawn from the seed: whole records (some chunks larger
    than a batch), or any byte count (records split across chunks, some
    chunks shorter than one record)."""
    rng = np.random.default_rng(seed + 1)
    rec = parse.frame_record_bytes(nv)
    view, bounds, pos = memoryview(blob), [], 0
    while pos < len(blob):
        step = (int(rng.integers(1, 3 * DIRECT_CAP)) * rec
                if chunking == "whole"
                else int(rng.choice([int(rng.integers(1, rec)),
                                     int(rng.integers(1, 3 * DIRECT_CAP
                                                      * rec))])))
        bounds.append((pos, pos + step))
        pos += step
    return lambda: (view[a:b] for a, b in bounds)


def _stage_frames(chunks_fn, nv, value_dtype, cap):
    """Drive one FrameSource replica (EVENT time) into a plain staging
    emitter; returns what it shipped, in order, and the replica: each
    packed batch's buffer and stamps, or a chunk-route batch's view."""
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    src = wt.FrameSource(chunks_fn, nv=nv, fields=_FIELDS[nv],
                         value_dtype=value_dtype, output_batch_size=cap)
    rep = src.replica_class(src, 0)
    rep.time_policy = wt.TimePolicy.EVENT
    em = DeviceStageEmitter([(_Capture(), 0)], cap, torch.device("cpu"))
    shipped = []
    em._ship_packed = lambda p: shipped.append(
        ("packed", p.buf.copy(), p.wm, p.frontier, p.ts_min, p.ts_max, p.n,
         p.dtypes, p.treedef, p.fmt))
    em._ship = lambda db: shipped.append(("batch", _batch_view(db)))
    rep.emitter = em
    rep.start()
    while not rep.exhausted:
        rep.tick(0)
    return shipped, rep


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
@pytest.mark.parametrize("chunking", ["whole", "split"])
@pytest.mark.parametrize("ts_kind", ["monotone", "out_of_order"])
@pytest.mark.parametrize("value_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nv", [1, 5])
@pytest.mark.parametrize("keys_kind", ["int32", "negative", "wide", "mixed",
                                       "switch"])
@pytest.mark.parametrize("cap", [DIRECT_CAP, 100])
def test_direct_route_stages_the_bytes_of_the_column_route(
        cap, keys_kind, nv, value_dtype, ts_kind, chunking, monkeypatch):
    """The direct route against the column route fed the numpy parser's
    columns of the same bytes: the same packed buffers, bit for bit, with
    the same stamps, sizes, dtypes and lane structure.  float64 values do
    not pack: both sides take the chunk route.  At 64 rows a batch every
    lane starts a cache line (the native pass streams 16-row blocks); at
    100 some do not (plain stores throughout)."""
    from windflow_tpu_torch import native as tnative
    seed = zlib.crc32(f"{keys_kind} {nv} {ts_kind} {chunking}".encode())
    blob = _direct_blob(keys_kind, nv, ts_kind, seed)
    chunks = _direct_chunks(blob, nv, chunking, seed)
    monkeypatch.setenv("WF_TPU_NO_NATIVE", "1")
    want, ref = _stage_frames(chunks, nv, value_dtype, cap)
    monkeypatch.delenv("WF_TPU_NO_NATIVE")
    tnative.reset_call_counts()
    got, rep = _stage_frames(chunks, nv, value_dtype, cap)
    packs = value_dtype is np.float32
    assert ref.direct_rows == 0
    assert rep.direct_rows == (DIRECT_N if packs else 0)
    assert rep.stats.outputs_sent == ref.stats.outputs_sent == DIRECT_N
    assert ("pack_frames" in tnative.call_counts()) is packs
    assert len(got) == len(want) >= -(-DIRECT_N // cap)
    for g, w in zip(got, want):
        assert g[0] == w[0] == ("packed" if packs else "batch")
        if packs:
            assert g[1].dtype == w[1].dtype and g[1].shape == w[1].shape
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:]
        else:
            gl, wl = g[1], w[1]
            assert list(gl[0]) == list(wl[0])
            for k in wl[0]:
                assert gl[0][k].dtype == wl[0][k].dtype, k
                assert gl[0][k].tobytes() == wl[0][k].tobytes(), k
            np.testing.assert_array_equal(gl[1], wl[1])
            assert gl[2:] == wl[2:]
    if keys_kind == "switch" and packs:
        # each change of the key lane's width finalizes the open batch
        assert {g[7][g[8][1].index("key")] for g in got} \
            == {"int32", "int64"}
        assert len(got) > -(-DIRECT_N // cap)


ROUTE_CAP, ROUTE_N, ROUTE_KEYS = 64, 1000, 8
#: the cases of test_direct_route_engages_where_the_packed_route_would:
#: the one that takes the direct route, then each that bypasses it
ROUTE_CASES = ["device", "csv", "ingress", "host", "probe", "keyed", "mesh",
               "no_native"]


def _route_blob(fmt):
    rng = np.random.default_rng(31)
    keys = rng.integers(0, ROUTE_KEYS, ROUTE_N)
    tss = np.arange(ROUTE_N, dtype=np.int64) * 5
    vals = rng.integers(-9, 10, (ROUTE_N, 2)).astype(np.float64)
    if fmt == "frames":
        return _frames(keys, tss, vals)
    return "".join(f"{k},{t},{a:g},{z:g}\n" for k, t, (a, z) in zip(
        keys.tolist(), tss.tolist(), vals.tolist())).encode()


def _route_run(case):
    """One graph a case, fed 997-byte chunks (records split across
    chunks, batches across chunks): the sink's rows, sorted, and the
    source replica.  Fields ``a`` and ``z`` put the key lane between
    the value lanes."""
    from windflow_tpu_torch.parallel import mesh as M
    fmt = "csv" if case == "csv" else "frames"
    policy = wt.TimePolicy.INGRESS if case == "ingress" \
        else wt.TimePolicy.EVENT
    kw = {"mesh": M.make_mesh(4, devices=["cpu"] * 4)} \
        if case == "mesh" else {}
    g = wt.PipeGraph(f"route_{case}", wt.ExecutionMode.DEFAULT, policy,
                     config=_port_cfg(**kw))
    src = wt.FrameSource(_chunks(_route_blob(fmt), 997), nv=2,
                         fields=["a", "z"], fmt=fmt,
                         output_batch_size=ROUTE_CAP)
    out = []
    pipe = g.add_source(src)
    if case == "host":
        pipe.add_sink(wt.Sink_Builder(lambda t: out.append(
            (t["key"], t["a"], t["z"])) if t is not None else None).build())
    else:
        if case in ("keyed", "mesh"):
            pipe.add(wt.ReduceGPU_Builder(lambda x, y: {
                n: torch.maximum(x[n], y[n]) for n in ("key", "a", "z")})
                .withKeyBy(lambda t: t["key"]).withMaxKeys(ROUTE_KEYS)
                .withMonoidCombiner("max")
                .withParallelism(2 if case == "keyed" else 1).build())
        else:
            if case != "probe":     # a map ahead: a fused tail, no probe
                pipe.add(wt.MapGPU_Builder(lambda t: {
                    "key": t["key"], "a": t["a"] * 2.0, "z": t["z"]})
                    .build())
            pipe.add(wt.Ffat_WindowsGPU_Builder(
                lambda t: t["a"] - t["z"], lambda x, y: x + y)
                .withCBWindows(16, 4).withKeyBy(lambda t: t["key"])
                .withMaxKeys(ROUTE_KEYS).build())

        def sink(c):
            if c is not None:
                out.extend(zip(*(np.asarray(c.cols[n]).tolist()
                                 for n in sorted(c.cols))))
        pipe.add_sink(wt.Sink_Builder(sink).withColumnarSink().build())
    g.run()
    return sorted(out), g, src.replicas[0]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_direct_route_engages_where_the_packed_route_would(case,
                                                          monkeypatch):
    """Frames into a plain staging emitter take the direct route, every
    row of them; CSV, INGRESS time, a host destination, a key probe, the
    keyed and the aligned-mesh staging emitters and WF_TPU_NO_NATIVE
    take the column route, none.  Each graph's results equal the same
    graph's with the direct route shut (the column route alone)."""
    from windflow_tpu_torch.io.frames import FrameSourceReplica
    from windflow_tpu_torch.parallel import emitters as E
    if case == "no_native":
        monkeypatch.setenv("WF_TPU_NO_NATIVE", "1")
    got, g, rep = _route_run(case)
    ing = g.stats()["Staging"]["Ingest"]
    direct = case == "device"
    assert ing["rows"] == rep.stats.outputs_sent == ROUTE_N
    assert ing["direct_rows"] == rep.direct_rows == (ROUTE_N if direct
                                                     else 0)
    assert ing["direct_share"] == (1.0 if direct else 0.0)
    assert (ing["direct_chunks"] > 0) is direct
    em = {"host": E.ForwardEmitter, "keyed": E.KeyedDeviceStageEmitter,
          "mesh": E.AlignedMeshStageEmitter}.get(case, E.DeviceStageEmitter)
    assert type(rep.emitter) is em
    assert (getattr(rep.emitter, "_shard_probe", None) is not None) \
        is (case in ("probe", "mesh"))
    monkeypatch.setattr(FrameSourceReplica, "_takes_direct",
                        lambda self: False)
    want, g0, rep0 = _route_run(case)
    assert rep0.direct_rows == 0 and len(want) > 0
    assert got == want


# ---------------------------------------------------------------------------
# DeviceSource (the families of tests/test_device_source.py)
# ---------------------------------------------------------------------------

DS_CAP, DS_NB, DS_K = 64, 6, 4


def _ds_batch_fn(pkg):
    if pkg is wt:
        def fn(i):
            lane = torch.arange(DS_CAP, dtype=torch.int32)
            return {"key": lane % DS_K,
                    "v": (i * DS_CAP + lane).to(torch.float32)}
        return fn
    import jax.numpy as jnp

    def fn(i):
        lane = jnp.arange(DS_CAP, dtype=jnp.int32)
        return {"key": lane % DS_K,
                "v": (i * DS_CAP + lane).astype(jnp.float32)}
    return fn


def _ds_wb(pkg):
    return wt.Ffat_WindowsGPU_Builder if pkg is wt \
        else wf.Ffat_WindowsTPU_Builder


def _ds_run(pkg, build_src, win, policy):
    rows = []
    w = (_ds_wb(pkg)(lambda t: t["v"], lambda a, b: a + b)
         .withKeyBy(lambda t: t["key"]).withMaxKeys(DS_K))
    w = (w.withCBWindows(*win[1:]) if win[0] == "cb"
         else w.withTBWindows(*win[1:])).build()
    g = pkg.PipeGraph("dev_src", pkg.ExecutionMode.DEFAULT, policy,
                      config=_cfg(pkg))
    g.add_source(build_src(pkg)).add(w).add_sink(pkg.Sink_Builder(
        lambda r: rows.append((int(r["key"]), int(r["wid"]),
                               float(r["value"])))
        if r is not None else None).build())
    g.run()
    return sorted(rows), w


def test_device_source_ffat_ingress_like_jax():
    def src(pkg):
        return (pkg.DeviceSource_Builder(_ds_batch_fn(pkg))
                .withCapacity(DS_CAP).withNumBatches(DS_NB).build())
    a, _ = _ds_run(wf, src, ("cb", 16, 8), wf.TimePolicy.INGRESS)
    b, _ = _ds_run(wt, src, ("cb", 16, 8), wt.TimePolicy.INGRESS)
    assert a == b
    per_key = {}
    for i in range(DS_NB * DS_CAP):
        per_key.setdefault(i % DS_K, []).append(float(i))
    want = sorted((k, w, sum(v[w * 8:w * 8 + 16])) for k, v in per_key.items()
                  for w in range(-(-len(v) // 8)))
    assert b == want


def test_device_source_event_time_tb_with_bounds_like_jax():
    usec = 1000

    def src(pkg):
        if pkg is wt:
            def ts_fn(i):
                return (i * DS_CAP + torch.arange(DS_CAP)) * usec
        else:
            import jax.numpy as jnp

            def ts_fn(i):
                return (i * DS_CAP + jnp.arange(DS_CAP)) * usec
        return (pkg.DeviceSource_Builder(_ds_batch_fn(pkg))
                .withCapacity(DS_CAP).withNumBatches(DS_NB)
                .withTimestampFn(ts_fn,
                                 lambda i: (i * DS_CAP + DS_CAP - 1) * usec)
                .withTimestampBounds(
                    lambda i: (i * DS_CAP * usec,
                               (i * DS_CAP + DS_CAP - 1) * usec)).build())
    a, wa = _ds_run(wf, src, ("tb", 32 * usec, 32 * usec),
                    wf.TimePolicy.EVENT)
    b, wb_ = _ds_run(wt, src, ("tb", 32 * usec, 32 * usec),
                     wt.TimePolicy.EVENT)
    assert a == b and wa.NP == wb_.NP
    want = {}
    for g_idx in range(DS_NB * DS_CAP):
        kw_ = (g_idx % DS_K, g_idx // 32)
        want[kw_] = want.get(kw_, 0.0) + float(g_idx)
    assert b == sorted((k, w, v) for (k, w), v in want.items())


def test_device_source_chained_map_like_jax():
    out = {}
    for pkg in (wf, wt):
        acc = []
        MB = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
        g = pkg.PipeGraph("dev_src_map", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.INGRESS, config=_cfg(pkg))
        g.add_source(pkg.DeviceSource_Builder(_ds_batch_fn(pkg))
                     .withCapacity(DS_CAP).withNumBatches(2).build()) \
            .add(MB(lambda t: {"key": t["key"], "v": t["v"] * 2.0}).build()) \
            .add_sink(pkg.Sink_Builder(lambda t: acc.append(
                (t["key"], t["v"])) if t is not None else None).build())
        g.run()
        out[pkg] = sorted(acc)
    assert out[wt] == out[wf]
    assert sorted(v for _, v in out[wt]) == [2.0 * x
                                             for x in range(2 * DS_CAP)]


def test_device_source_validation_like_jax():
    for pkg in (wf, wt):
        fn = _ds_batch_fn(pkg)
        with pytest.raises(pkg.WindFlowError):
            pkg.DeviceSource_Builder(fn).withCapacity(0) \
                .withNumBatches(3).build()
        with pytest.raises(pkg.WindFlowError):
            pkg.DeviceSource_Builder(fn).withCapacity(8) \
                .withNumBatches(3).withOutputBatchSize(8)
        for bad in ("withKeyBy", "withRebalancing"):
            with pytest.raises(pkg.WindFlowError):
                getattr(pkg.DeviceSource_Builder(fn), bad)(
                    *([lambda t: 0] if bad == "withKeyBy" else []))
        lanes = (torch.arange(DS_CAP, dtype=torch.int64) if pkg is wt
                 else __import__("jax.numpy").numpy.arange(DS_CAP))
        for policy, ts_fn, match in (
                (pkg.TimePolicy.EVENT, None, "ts_fn"),
                (pkg.TimePolicy.INGRESS, lambda i: lanes, "EVENT")):
            b = pkg.DeviceSource_Builder(fn).withCapacity(DS_CAP) \
                .withNumBatches(1)
            if ts_fn is not None:
                b = b.withTimestampFn(ts_fn, lambda i: DS_CAP)
            g = pkg.PipeGraph("bad", pkg.ExecutionMode.DEFAULT, policy,
                              config=_cfg(pkg))
            g.add_source(b.build()).add_sink(
                pkg.Sink_Builder(lambda t: None).build())
            with pytest.raises(pkg.WindFlowError, match=match):
                g.run()
        # n_batches = 0: an empty stream ends at once
        got = []
        g = pkg.PipeGraph("empty", pkg.ExecutionMode.DEFAULT,
                          config=_cfg(pkg))
        g.add_source(pkg.DeviceSource_Builder(fn).withCapacity(DS_CAP)
                     .withNumBatches(0).build()) \
            .add_sink(pkg.Sink_Builder(got.append).build())
        g.run()
        assert got == [None]


def test_device_source_refuses_lanes_off_the_graph_device():
    g = wt.PipeGraph("shape", config=_port_cfg())
    g.add_source(wt.DeviceSource_Builder(
        lambda i: {"key": torch.zeros(3, dtype=torch.int32)})
        .withCapacity(8).withNumBatches(1).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    with pytest.raises(wt.WindFlowError, match="leading dimension 8"):
        g.run()


# ---------------------------------------------------------------------------
# the declared floating-point sum repeats bit for bit
# ---------------------------------------------------------------------------

def test_run_sums_fixed_order():
    from windflow_tpu_torch.windows.ffat_kernels import _run_sums
    rng = np.random.default_rng(12)
    lens = rng.integers(1, 40, 60)
    runs = np.repeat(np.cumsum(rng.integers(1, 5, 60)), lens)
    x = rng.integers(-50, 50, lens.sum()).astype(np.float32)
    got = _run_sums(torch.from_numpy(x.copy()), torch.from_numpy(runs),
                    64).numpy()
    ends = np.cumsum(lens) - 1
    want = np.add.reduceat(x.astype(np.float64), np.cumsum(lens) - lens)
    np.testing.assert_array_equal(got[ends], want)      # integer: exact


def _cb_float_sum(pkg, keys, tss, vals):
    (cols, _), _ = _run_cb(pkg, _frames(keys, tss, vals), 5000, True)
    return cols


@pytest.mark.parametrize("path", ["cb", "tb"])
def test_declared_float_sum_repeats_bit_for_bit(path):
    if path == "cb":
        keys, tss, vals = _cb_data(7, floats=True)
        runs = [_cb_float_sum(pkg, keys, tss, vals) for pkg in (wt, wt, wf)]
        sort_by = ("key", "wid")
    else:
        rng = np.random.default_rng(8)
        n = 3000
        keys = rng.integers(0, 8, n)
        tss = np.arange(n, dtype=np.int64) * 300
        vals = rng.standard_normal((n, 1))
        blob = _frames(keys, tss, vals)

        def run(pkg):
            _, _, WB, FS = _builders(pkg)
            got = []
            g = pkg.PipeGraph("tb_sum", pkg.ExecutionMode.DEFAULT,
                              pkg.TimePolicy.EVENT, config=_cfg(pkg))
            g.add_source(FS(_chunks(blob, 4000), nv=1,
                            output_batch_size=512)) \
                .add(WB(lambda t: t["v0"], lambda a, b: a + b)
                     .withTBWindows(40_000, 10_000)
                     .withKeyBy(lambda t: t["key"]).withMaxKeys(8)
                     .withSumCombiner().build()) \
                .add_sink(pkg.Sink_Builder(lambda c: got.append(c)
                                           if c is not None else None)
                          .withColumnarSink().build())
            g.run()
            return _columns(got)[0]
        runs = [run(pkg) for pkg in (wt, wt, wf)]
        sort_by = ("key", "wid")
    first, second, ref = runs
    for n in first:
        assert first[n].dtype == second[n].dtype
        assert first[n].tobytes() == second[n].tobytes(), n
    o = np.lexsort([first[n] for n in reversed(sort_by)])
    r = np.lexsort([ref[n] for n in reversed(sort_by)])
    for n in sort_by:
        np.testing.assert_array_equal(first[n][o], ref[n][r])
    np.testing.assert_allclose(first["value"][o], ref["value"][r],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["cb", "tb"])
def test_declared_float_sum_takes_no_float_scatter_add(path, monkeypatch):
    """The route behind the repeatable bits: a declared f32 sum step adds
    no floating-point lane with ``index_add_`` (float atomics on the
    card); integer counts may."""
    added = []
    orig = torch.Tensor.index_add_

    def spy(self, *a, **k):
        added.append(self.dtype)
        return orig(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    rng = np.random.default_rng(14)
    n = 1500
    keys = rng.integers(0, 8, n)
    blob = _frames(keys, np.arange(n) * 300, rng.standard_normal((n, 1)))
    got = []
    WB = wt.Ffat_WindowsGPU_Builder
    wb = WB(lambda t: t["v0"], lambda a, b: a + b) \
        .withKeyBy(lambda t: t["key"]).withMaxKeys(8).withSumCombiner()
    wb = wb.withCBWindows(64, 16) if path == "cb" \
        else wb.withTBWindows(40_000, 10_000)
    g = wt.PipeGraph("no_float_atomics", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=_port_cfg())
    g.add_source(wt.FrameSource(_chunks(blob, 4000), nv=1,
                                output_batch_size=256)) \
        .add(wb.build()).add_sink(wt.Sink_Builder(
            lambda c: got.append(c) if c is not None else None)
            .withColumnarSink().build())
    g.run()
    assert got and not any(d.is_floating_point for d in added)
