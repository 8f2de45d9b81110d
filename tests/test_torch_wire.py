"""The port's wire plane (windflow_tpu_torch/wire.py, the wire route of
parallel/emitters.DeviceStageEmitter, batch.unpack_body's decode) against
the JAX package's (windflow_tpu/wire.py).

Seeded numpy input goes through both packages:

* every lane of ``tests/test_wire.py``'s 13-lane ``ADVERSARIAL`` matrix
  (constant, all-null, random, NaN/inf/-0.0 bits, low cardinality, sorted
  with gaps, a timestamp cadence, int64 and int32 extremes, uint64 above
  2^63, full-range uint32) and a partial batch: the port's encoder gives
  the JAX encoder's wire words and codec table bit for bit, the port's
  torch decode of those words equals the input bit for bit, and it
  decodes the JAX encoder's buffers;
* a codec misfit degrades to raw for one batch and the next reseeds;
  ``size_class`` equals JAX's and the pool recycles across codec churn;
* ``wire_enabled`` resolves "auto" from the device; the enabled/raw
  verdict equals JAX's on every graph built here (a spec-less source
  ships raw; the off switch attaches nothing);
* graph A/B: FrameSource → CB window, TB window and sorted reduce, and a
  record source → reduce (the record path's wire route): wire on equals
  wire off in the port and equals the JAX package with wire on, record
  for record with dtypes, and the H2D wire/logical byte split equals
  JAX's ``Bytes_H2D`` split.
Exact everywhere: the values are integer-valued.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import staging as jstaging
from windflow_tpu import wire as jwire
from windflow_tpu.io.frames import FrameSource as JFrameSource
from windflow_tpu_torch import staging, wire

# one intra-op thread: toy sizes beside other test workers
torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
_CAP = 2048
#: tests/test_wire.py's adversarial matrix, the same seed and draws
ADVERSARIAL = {
    "constant_i32": np.full(_CAP, -7, np.int32),
    "all_null_i32": np.zeros(_CAP, np.int32),
    "all_null_f32": np.zeros(_CAP, np.float32),
    "random_i32": _RNG.integers(-2**31, 2**31, _CAP).astype(np.int32),
    "random_f32": _RNG.random(_CAP, dtype=np.float32),
    "nan_inf_f32": np.tile(np.array([np.nan, np.inf, -np.inf, -0.0],
                                    np.float32), _CAP // 4),
    "low_card_i32": _RNG.integers(0, 61, _CAP).astype(np.int32),
    "sorted_gaps_i64": np.sort(
        _RNG.integers(0, 10**9, _CAP)).astype(np.int64),
    "cadence_i64": np.arange(_CAP, dtype=np.int64) * 1_000 + 5,
    "extremes_i64": np.tile(np.array(
        [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1],
        np.int64), _CAP // 4),
    "extremes_i32": np.tile(np.array(
        [np.iinfo(np.int32).min, np.iinfo(np.int32).max], np.int32),
        _CAP // 2),
    "big_u64": _RNG.integers(0, 2**63, _CAP).astype(np.uint64)
    + np.uint64(2**63 - 1),
    "uint32_full": _RNG.integers(0, 2**32, _CAP).astype(np.uint32),
}


def _logical(pkg_staging, lane, cap, tss, n=None):
    dt = str(lane.dtype)
    b = pkg_staging.PackedBatchBuilder((dt,), cap)
    b.append([lane[:n]], tss[:n])
    return b.finish().copy()


def _decode(fmt, dt, cap, words):
    """The port's torch decode of wire words, as (lane, ts) numpy."""
    cols = wire.build_wire_decode(fmt, (dt,), cap)(
        torch.from_numpy(np.ascontiguousarray(words).view(np.int32)))
    return cols[0].numpy(), cols[1].numpy()


def _same_words(a, b, fmt, dtypes, cap):
    """Two wire buffers carry the same words: every header and payload
    word and the fill count (the size-class pad is never written or read:
    pooled and fresh buffers leave it undefined)."""
    if fmt is None:
        return np.array_equal(a, b)
    used = wire.wire_words_total(fmt.codecs, tuple(dtypes) + ("int64",),
                                 cap) - 1
    return a.shape == b.shape and np.array_equal(a[:used], b[:used]) \
        and a[-1] == b[-1]


def _fmt_tuple(fmt):
    return None if fmt is None else (
        tuple(tuple(c) for c in fmt.codecs), fmt.words)


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_encoder_words_and_codecs_equal_jax_and_decode_bit_exact(name):
    lane = ADVERSARIAL[name]
    dt = str(lane.dtype)
    tss = np.arange(_CAP, dtype=np.int64) * 17
    buf = _logical(staging, lane, _CAP, tss)
    assert np.array_equal(buf, _logical(jstaging, lane, _CAP, tss))
    enc = wire.WireEncoder((dt,), _CAP, reseed_every=4)
    jenc = jwire.WireEncoder((dt,), _CAP, reseed_every=4)
    wbuf, fmt = enc.encode(buf.copy())
    jbuf, jfmt = jenc.encode(buf.copy())
    assert _fmt_tuple(fmt) == _fmt_tuple(jfmt), name
    assert wbuf.dtype == jbuf.dtype == np.uint32
    assert _same_words(wbuf, jbuf, fmt, (dt,), _CAP), name
    assert enc.codec_table() == jenc.codec_table()
    if fmt is None:
        return      # compression lost: the logical buffer ships
    for words in (wbuf, jbuf):
        got, got_ts = _decode(fmt, dt, _CAP, words)
        # bit-exact: NaN payload bits and -0.0 survive
        assert got.dtype == lane.dtype
        assert np.array_equal(got.view(np.uint8), lane.view(np.uint8)), name
        assert np.array_equal(got_ts, tss)


def test_partial_batch_zero_tail_round_trips():
    """finish() zero-pads the tail; the decode reproduces those zeros and
    the fill count survives the re-pack."""
    cap, n = 256, 100
    lane = _RNG.integers(0, 50, n).astype(np.int32)
    tss = np.arange(n, dtype=np.int64)
    buf = _logical(staging, lane, cap, tss, n)
    assert np.array_equal(buf, _logical(jstaging, lane, cap, tss, n))
    wbuf, fmt = wire.WireEncoder(("int32",), cap, 1).encode(buf.copy())
    jbuf, jfmt = jwire.WireEncoder(("int32",), cap, 1).encode(buf.copy())
    assert fmt is not None and _fmt_tuple(fmt) == _fmt_tuple(jfmt)
    assert _same_words(wbuf, jbuf, fmt, ("int32",), cap)
    assert int(wbuf[-1]) == n
    got, got_ts = _decode(fmt, "int32", cap, wbuf)
    assert np.array_equal(got[:n], lane) and not got[n:].any()
    assert np.array_equal(got_ts[:n], tss) and not got_ts[n:].any()
    # the whole unpack: the valid mask from the fill count
    from windflow_tpu_torch.batch import unpack_body
    cols, ts, valid = unpack_body(("int32",), cap, wire=fmt)(
        torch.from_numpy(wbuf.view(np.int32)))
    assert int(valid.sum()) == n and bool(valid[:n].all())


def test_codec_misfit_degrades_to_raw_then_reseeds():
    """A lane whose data stops matching its codec ships raw for that
    batch (counted) and the next batch re-chooses: codec by codec the
    same choices as the JAX encoder."""
    cap = 512
    enc = wire.WireEncoder(("int32",), cap, reseed_every=100)
    jenc = jwire.WireEncoder(("int32",), cap, reseed_every=100)

    def encode(lane):
        buf = _logical(staging, lane, cap, np.zeros(cap, np.int64))
        out, jout = enc.encode(buf.copy()), jenc.encode(buf.copy())
        assert _fmt_tuple(out[1]) == _fmt_tuple(jout[1])
        assert _same_words(out[0], jout[0], out[1], ("int32",), cap)
        return out

    _, fmt1 = encode(np.full(cap, 3, np.int32))        # seeds CONST
    assert fmt1.codecs[0].kind == wire.CONST
    lane2 = _RNG.integers(-2**31, 2**31, cap).astype(np.int32)
    wbuf2, fmt2 = encode(lane2)
    assert enc.stats.fallback_lanes >= 1
    if fmt2 is not None:            # the ts lane still compresses
        assert fmt2.codecs[0].kind == wire.RAW
        assert np.array_equal(_decode(fmt2, "int32", cap, wbuf2)[0], lane2)
    _, fmt3 = encode(np.full(cap, 9, np.int32))        # forced reseed
    assert fmt3.codecs[0].kind == wire.CONST
    assert enc.stats.reseeds >= 2
    assert enc.stats.fallback_lanes == jenc.stats.fallback_lanes
    assert enc.stats.reseeds == jenc.stats.reseeds


@pytest.mark.parametrize("n", [1, 256, 257, 1000, 5000, 65536, 100000,
                               (1 << 20) + 3])
def test_size_class_equals_jax(n):
    c = staging.size_class(n)
    assert c == jstaging.size_class(n)
    assert c >= n and staging.size_class(c) == c
    assert n <= 256 or (c - n) / c <= 0.25


def test_pool_reuses_across_codec_churn():
    """Two wire batches of different encoded sizes in one size class hit
    the pool instead of minting a slot each; the encoder acquires its
    buffers at the class and hands the logical scratch back."""
    pool = staging.StagingPool(depth=4)
    a = pool.acquire(staging.size_class(5000))
    pool.release(a, None)
    hits = pool.hits
    b = pool.acquire(staging.size_class(5100))
    assert staging.size_class(5000) == staging.size_class(5100)
    assert pool.hits == hits + 1 and b is a
    cap = 4096
    enc = wire.WireEncoder(("int32",), cap, reseed_every=1)
    sizes = set()
    for i in range(6):
        lane = _RNG.integers(0, 50 + 40 * i, cap).astype(np.int32)
        bld = staging.PackedBatchBuilder(("int32",), cap, pool=pool)
        bld.append([lane], np.arange(cap, dtype=np.int64))
        released = pool.releases
        wbuf, fmt = enc.encode(bld.finish(), pool=pool)
        assert fmt is not None and pool.releases == released + 1
        assert wbuf.shape[0] == fmt.words == staging.size_class(
            wire.wire_words_total(fmt.codecs, ("int32", "int64"), cap))
        sizes.add(wbuf.shape[0])
        pool.release(wbuf, None)
    # six batches of shifting cardinality: few classes, every later
    # acquire of a class already seen is a hit
    assert len(sizes) < 6 and pool.hits >= 6 - len(sizes)


def test_wire_enabled_resolves_auto_on_the_device():
    cfg = wt.Config(device="cpu")
    assert cfg.wire_compression == "auto"
    assert wire.wire_enabled(cfg) is False
    # "auto" reads the configured device; no card is needed to resolve it
    assert wire.wire_enabled(wt.Config(device="cuda")) is True
    assert wire.wire_enabled(wt.Config(device="cpu",
                                       wire_compression=True)) is True
    for off in (False, "0", "off"):
        assert wire.wire_enabled(wt.Config(device="cuda",
                                           wire_compression=off)) is False
    with pytest.raises(wt.WindFlowError):
        wire.wire_enabled(wt.Config(wire_compression="sometimes"))


# ---------------------------------------------------------------------------
# graphs: the verdict, A/B records, byte split
# ---------------------------------------------------------------------------

N, CAP, KEYS = 4096, 256, 8
SPEC = {"key": np.int32(0), "v": np.float32(0.0)}


def _blob(n=N, seed=7):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    rec["k"] = rng.integers(0, KEYS, n)
    rec["ts"] = np.arange(n, dtype=np.int64) * 500
    rec["v"] = rng.integers(0, 100, n)
    return rec.tobytes()


def _frames(pkg, spec=True):
    blob = _blob()
    step = CAP * 24

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    cls = wt.FrameSource if pkg is wt else JFrameSource
    src = cls(chunks, nv=1, fields=["v"], output_batch_size=CAP)
    if spec:
        # the JAX FrameSource takes no constructor spec: its preflight
        # reads the attribute
        src.record_spec = SPEC
    return src


def _records(pkg, spec=True):
    rng = np.random.default_rng(11)
    ks, vs = rng.integers(0, 64, 3000), rng.integers(0, 1000, 3000)
    recs = [{"key": int(k), "v": np.float32(v), "t": 250 * i}
            for i, (k, v) in enumerate(zip(ks, vs))]
    b = (wt if pkg is wt else wf).Source_Builder(lambda: iter(recs)) \
        .withOutputBatchSize(CAP).withTimestampExtractor(lambda r: r["t"])
    if spec:
        b = b.withRecordSpec({"key": np.int64(0), "v": np.float32(0.0),
                              "t": np.int64(0)})
    return b.build()


def _tail(pkg, family):
    jax_side = pkg is wf
    FB = wf.Ffat_WindowsTPU_Builder if jax_side \
        else wt.Ffat_WindowsGPU_Builder
    RB = wf.ReduceTPU_Builder if jax_side else wt.ReduceGPU_Builder
    if family == "window_cb":
        return (FB(lambda t: t["v"], lambda a, b: a + b)
                .withCBWindows(64, 32).withKeyBy(lambda t: t["key"])
                .withMaxKeys(KEYS).withName("w").build())
    if family == "window_tb":
        return (FB(lambda t: t["v"], lambda a, b: a + b)
                .withTBWindows(16_000, 4_000).withKeyBy(lambda t: t["key"])
                .withMaxKeys(KEYS).withLateness(8_000).withName("w")
                .build())
    if family == "records":
        return (RB(lambda a, b: {"key": a["key"], "v": a["v"] + b["v"],
                                 "t": a["t"]})
                .withKeyBy(lambda t: t["key"]).withName("w").build())
    return (RB(lambda a, b: {"key": a["key"], "v": a["v"] + b["v"]})
            .withKeyBy(lambda t: t["key"]).withName("w").build())


def _cfg(pkg, wire_on, **kw):
    kw = dict(wire_compression=wire_on, megastep_sweeps=1,
              punctuation_interval_usec=10 ** 12, **kw)
    if pkg is wt:
        return wt.Config(device="cpu", **kw)
    return dataclasses.replace(wf.default_config, **kw)


def _run(pkg, family, wire_on, spec=True, middle=None):
    """One graph run; returns (sunk records, stats)."""
    out = []
    # event time throughout: ingress stamps would differ from run to run
    g = pkg.PipeGraph(
        "wire_ab", time_policy=pkg.TimePolicy.EVENT,
        config=_cfg(pkg, wire_on))
    src = _records(pkg, spec) if family == "records" \
        else _frames(pkg, spec)
    pipe = g.add_source(src)
    if middle is not None:
        pipe = pipe.add(middle(pkg))
    pipe.add(_tail(pkg, family)).add_sink(pkg.Sink_Builder(
        lambda r: out.append(r) if r is not None else None).build())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the JAX side's named WF606
        g.run()
    return out, g.stats()


def _norm(recs):
    """Records as sorted rows of (field, type name, value): exact, with
    the kind of every value."""
    rows = []
    for r in recs:
        rows.append(tuple(sorted(
            (k, np.asarray(v).dtype.kind, np.asarray(v).item())
            for k, v in r.items())))
    return sorted(rows)


@pytest.mark.parametrize("family", ["window_cb", "window_tb",
                                    "reduce_sorted", "records"])
def test_graph_wire_on_equals_off_and_jax(family):
    on, st_on = _run(wt, family, True)
    off, st_off = _run(wt, family, False)
    jon, jst = _run(wf, family, True)
    assert on, "empty output proves nothing"
    assert _norm(on) == _norm(off) == _norm(jon)
    ws, jws = st_on["Staging"]["Wire"], jst["Staging"]["Wire"]
    assert ws["enabled"] and ws["encoders"] == jws["encoders"] == 1
    assert ws["batches"] == jws["batches"] > 0
    for k in ("raw_batches", "fallback_lanes", "reseeds", "logical_bytes",
              "wire_bytes", "compression_ratio", "codecs"):
        assert ws[k] == jws[k], k
    # the byte split: wire bytes as shipped, logical bytes as decoded
    assert st_on["Bytes_H2D_total"] == jst["Bytes_H2D_total"]
    assert st_on["Bytes_H2D_logical_total"] == jst["Bytes_H2D_logical_total"]
    assert 0 < st_on["Bytes_H2D_total"] < st_on["Bytes_H2D_logical_total"]
    assert st_off["Bytes_H2D_total"] == st_off["Bytes_H2D_logical_total"]
    if family != "records":
        # the same packed buffers, uncompressed (the record path off wire
        # stages lane by lane instead)
        assert st_off["Bytes_H2D_total"] == st_on["Bytes_H2D_logical_total"]
    assert st_off["Staging"]["Wire"]["encoders"] == 0


def _host_map(pkg):
    return pkg.Map_Builder(lambda t: t).withOutputBatchSize(CAP).build()


def _dev_map(pkg):
    b = wf.MapTPU_Builder if pkg is wf else wt.MapGPU_Builder
    return b(lambda t: {"key": t["key"], "v": t["v"] * 2}).build()


@pytest.mark.parametrize("case", ["specless_frames", "specless_records",
                                  "declared_frames", "host_map_between",
                                  "device_map_between"])
def test_enabled_raw_verdict_equals_jax(case):
    """The port's own spec walk reaches JAX's preflight verdict: a
    declared source (records or frames) compresses, through device
    operators; a spec-less source, or a host Map between, ships raw."""
    family = "records" if case == "specless_records" else "reduce_sorted"
    spec = case not in ("specless_frames", "specless_records")
    middle = {"host_map_between": _host_map,
              "device_map_between": _dev_map}.get(case)
    got, st = _run(wt, family, True, spec=spec, middle=middle)
    jgot, jst = _run(wf, family, True, spec=spec, middle=middle)
    ws, jws = st["Staging"]["Wire"], jst["Staging"]["Wire"]
    assert ws["enabled"] and jws["enabled"]
    assert ws["encoders"] == jws["encoders"]
    assert ws["batches"] == jws["batches"]
    assert (ws["encoders"] > 0) == (case in ("declared_frames",
                                             "device_map_between"))
    assert _norm(got) == _norm(jgot)


def test_specless_source_ships_raw_passthrough():
    """A spec-less record source under forced compression stages with no
    encoder (the JAX package's WF606 downgrade), record path intact."""
    got = []
    records = [{"key": i % 8, "v": np.float32(i)} for i in range(512)]
    g = wt.PipeGraph("wire_raw", config=wt.Config(
        device="cpu", wire_compression=True))
    g.add_source(wt.Source_Builder(lambda: iter(records))
                 .withOutputBatchSize(128).build()) \
        .add(wt.MapGPU_Builder(lambda t: {"key": t["key"],
                                          "v": t["v"] * 2.0}).build()) \
        .add_sink(wt.Sink_Builder(lambda r: got.append(r)
                                  if r is not None else None).build())
    g.run()
    ws = g.stats()["Staging"]["Wire"]
    assert ws["enabled"] and ws["encoders"] == 0 and ws["batches"] == 0
    em = g.pipes[0].operators[0].replicas[0].emitter
    assert em._wire_on is False and em.record_batches == 4
    assert sorted(float(r["v"]) for r in got) == [2.0 * i
                                                  for i in range(512)]


@pytest.mark.parametrize("setting", ["auto", False])
def test_off_path_attaches_nothing(setting):
    """Off (and "auto" on the CPU) attaches no encoder anywhere: the
    emitter keeps one flag check a batch and the raw bytes."""
    _, st = _run(wt, "window_cb", setting)
    ws = st["Staging"]["Wire"]
    assert not ws["enabled"] and ws["encoders"] == 0
    assert st["Bytes_H2D_total"] == st["Bytes_H2D_logical_total"] > 0
