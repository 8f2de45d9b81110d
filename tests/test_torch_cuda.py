"""The port's CUDA kernels against their plain torch versions, on the
card (windflow_tpu_torch/kernels/ffat_cuda.py and reduce_cuda.py).
Every test is marked
``cuda`` and skips without an NVIDIA GPU.  This file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The grouping and fold kernels are exact, so those comparisons are bit
for bit.  The time-window checks at the end run a TB graph whose (key,
pane) ids stay under the grouping kernel's gate: its records equal the
kill switch's, the kernel launches on every step, and a step makes no
host read.  The dense-table kernel is bit for bit too on max, min,
integers, bool and integer-valued f32 sums; a random f32 sum is held to
identical bits from call to call and to rtol 1e-5 against the plain
scatter-add (the declared-sum reassociation tolerance).
"""

import numpy as np
import pytest
import torch

from windflow_tpu_torch import WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.kernels import reduce_cuda as rc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,NB", [(262144, 1025), (1000, 2), (262221, 4096),
                                  (1, 2)])
def test_cuda_grouping_kernel_matches_plain(cuda_device, B, NB):
    rng = np.random.default_rng(B + NB)
    ids = torch.from_numpy(rng.integers(0, NB, B).astype(np.int32)) \
        .to(cuda_device)
    fc.reset_launch_counts()
    got = fc.grouping_rank_hist(ids, NB)
    assert fc.launch_counts()["grouping_rank_hist"] == 1
    for g, w in zip(got, fc.grouping_rank_hist_plain(ids, NB)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,NB,one", [(262144, 1025, 7), (4097, 2, 1),
                                      (4096, 4096, 4095),
                                      (1 << 22, 1025, None),
                                      (1 << 22, 4096, None),
                                      (4095, 4096, None),
                                      (262221, 1025, None)])
def test_cuda_grouping_kernel_edges(cuda_device, B, NB, one):
    """The redesign's edges: one id for every lane (the widest match-any
    group), NB = 4096 (the warps' counts above 48 KB of shared memory),
    the gate's 2^22 lanes, B not a multiple of the 2,048-lane tile."""
    rng = np.random.default_rng(B + NB)
    ids = rng.integers(0, NB, B) if one is None else np.full(B, one)
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    fc.reset_launch_counts()
    got = fc.grouping_rank_hist(ids, NB)
    assert fc.launch_counts()["grouping_rank_hist"] == 1
    for g, w in zip(got, fc.grouping_rank_hist_plain(ids, NB)):
        assert torch.equal(g, w)
    order, _ = fc.order_hist(ids, NB)
    assert torch.equal(order.long(), torch.sort(ids, stable=True).indices)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("K,N,R", [(1024, 2057, 8), (5, 257, 13),
                                   (3, 300, 1), (2, 3585, 512)])
def test_cuda_fold_kernel_matches_plain(cuda_device, monoid, dtype, K, N, R):
    rng = np.random.default_rng(K + N + R)
    x = torch.from_numpy(rng.standard_normal((K, N)) * 1000).to(dtype) \
        .to(cuda_device)
    v = torch.from_numpy(rng.random((K, N)) < 0.8).to(cuda_device)
    fc.reset_launch_counts()
    got = fc.sliding_fold(x, v, R, monoid)
    assert fc.launch_counts()["sliding_fold"] == 1
    assert torch.equal(got, fc.fold_leaf_plain(x, v, R, monoid))


def _fold_mask(rng, K, N, R, pattern):
    """A [K, N] pane mask: "random" (80% valid), "main" (the FFAT step's:
    R-1 carried panes then 1-3 new ones a key, none for keys with
    ``key & 7 == 7``), "rows" (every third row all invalid, every third
    all valid, the rest random)."""
    if pattern == "main":
        live = (R - 1) + rng.integers(1, 4, K)
        v = np.arange(N)[None, :] < live[:, None]
        v[(np.arange(K) & 7) == 7] = False
        return v
    v = rng.random((K, N)) < 0.8
    if pattern == "rows":
        v[0::3] = False
        v[1::3] = True
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("K,N,R,pattern", [
    (1024, 2057, 8, "main"), (1024, 2056, 8, "main"), (64, 2056, 8, "rows"),
    (33, 2057, 2, "rows"), (9, 300, 7, "random"), (9, 300, 31, "main"),
    (9, 300, 33, "random"), (2, 3585, 512, "rows"), (5, 5, 8, "random"),
    (9, 300, 16, "rows"), (9, 300, 17, "main"),
    (4, 3, 33, "rows"), (1, 2057, 8, "random"), (1, 1, 1, "random"),
    (7, 13, 16, "main")])
def test_cuda_fold_kernel_edges(cuda_device, monoid, dtype, K, N, R,
                                pattern):
    """The redesign's edges, bit for bit, one launch a call: the main
    path's mask (whole warps of dead runs), row pitches that are and are
    not a multiple of 4 (16-byte rows and runs across row starts), all-
    invalid and all-valid rows, R on both sides of the register path's
    16 and at the gate's 512, N < R, K = 1, and -0.0 at column 0 (the
    identity left of it makes 0.0 + -0.0 round as the plain fold does)."""
    rng = np.random.default_rng(K * 31 + N + R)
    x = rng.standard_normal((K, N)) * 1000
    x[:, 0] = -0.0
    x = torch.from_numpy(x).to(dtype).to(cuda_device)
    v = torch.from_numpy(_fold_mask(rng, K, N, R, pattern)).to(cuda_device)
    fc.reset_launch_counts()
    got = fc.sliding_fold(x, v, R, monoid)
    assert fc.launch_counts()["sliding_fold"] == 1
    want = fc.fold_leaf_plain(x, v, R, monoid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("run", [4, 8, 16])
@pytest.mark.parametrize("pattern", ["random", "main"])
def test_cuda_fold_kernel_runs_per_thread(cuda_device, monkeypatch, run,
                                          pattern):
    """Every candidate run length of the register path (FOLD_RUN) at the
    main shape, and a view 4 bytes off 16-byte alignment (the shared-
    memory path) at R = 8."""
    monkeypatch.setattr(fc, "FOLD_RUN", run)
    rng = np.random.default_rng(run)
    K, N, R = 1024, 2057, 8
    base = torch.from_numpy(rng.standard_normal((K + 1, N))
                            .astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(_fold_mask(rng, K, N, R, pattern)).to(cuda_device)
    for x in (base[:K], base[1:]):
        for monoid in ("sum", "max", "min"):
            assert torch.equal(fc.sliding_fold(x, v, R, monoid),
                               fc.fold_leaf_plain(x, v, R, monoid))


@pytest.mark.cuda
@pytest.mark.parametrize("nleaves,launches", [(2, 1), (4, 1), (5, 2)])
def test_cuda_fold_pytree_in_one_launch(cuda_device, nleaves, launches):
    """f32 and i32 leaves of one pytree fold together, four a launch."""
    rng = np.random.default_rng(nleaves)
    K, N, R = 1024, 2057, 8
    v = torch.from_numpy(_fold_mask(rng, K, N, R, "main")).to(cuda_device)
    tree = {}
    for i in range(nleaves):
        a = rng.integers(-1000, 1000, (K, N))
        tree[f"l{i}"] = torch.from_numpy(
            a.astype(np.float32 if i % 2 == 0 else np.int32)).to(cuda_device)
    for monoid in ("sum", "max", "min"):
        fc.reset_launch_counts()
        got = fc.sliding_fold(tree, v, R, monoid)
        assert fc.launch_counts()["sliding_fold"] == launches
        for k, leaf in tree.items():
            assert got[k].dtype == leaf.dtype
            assert torch.equal(got[k], fc.fold_leaf_plain(leaf, v, R, monoid))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    with pytest.raises(WindFlowError):
        fc.grouping_rank_hist(torch.zeros(8, dtype=torch.int64,
                                          device=cuda_device), 4)
    with pytest.raises(WindFlowError):
        fc.sliding_fold(torch.zeros((4, 8), dtype=torch.float64,
                                    device=cuda_device),
                        torch.ones((4, 8), dtype=torch.bool,
                                   device=cuda_device), 2, "sum")
    with pytest.raises(WindFlowError):
        fc.sliding_fold({"a": torch.zeros((4, 8), device=cuda_device),
                         "b": torch.zeros((4, 9), device=cuda_device)},
                        torch.ones((4, 8), dtype=torch.bool,
                                   device=cuda_device), 2, "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("B,S", [(262144, 1024), (64, 8), (300, 17),
                                 (100, 4096), (5, 1), (262221, 4096)])
def test_cuda_dense_table_kernel_matches_plain(cuda_device, monoid, B, S):
    rng = np.random.default_rng(B + S + len(monoid))
    row = torch.from_numpy(rng.integers(-2, S + 2, B).astype(np.int32)) \
        .to(cuda_device)
    leaves = [rng.integers(-2**40, 2**40, (B, 3)).astype(np.int64),
              rng.integers(-100, 100, B).astype(np.float32),
              rng.integers(-1000, 1000, (B, 8)).astype(np.int32),
              rng.random(B) < 0.3]
    leaves = [torch.from_numpy(l).to(cuda_device) for l in leaves]
    inits = [fc.monoid_identity(monoid, l.dtype) for l in leaves]
    fc.reset_launch_counts()
    got = rc.dense_monoid_table(row, leaves, [monoid] * 4, inits, S)
    assert fc.launch_counts()["dense_monoid_table"] == 1
    want = rc.dense_monoid_table_plain(row, leaves, [monoid] * 4, inits, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("B,S,one", [(262144, 1024, 5), (4097, 4096, 4095),
                                     (1 << 22, 1024, None),
                                     (4095, 33, None), (2049, 4096, None)])
def test_cuda_dense_table_kernel_edges(cuda_device, monoid, B, S, one):
    """The redesign's edges: every lane in one slot (the widest match-any
    group and f32 chain), S = 4096 (tables above 48 KB of shared
    memory), the gate's 2^22 lanes, B not a multiple of the 2,048-lane
    tile; one launch a call, bit for bit."""
    rng = np.random.default_rng(B + S + len(monoid))
    row = rng.integers(-2, S + 2, B) if one is None else np.full(B, one)
    row = torch.from_numpy(row.astype(np.int32)).to(cuda_device)
    leaves = [rng.integers(-2**40, 2**40, (B, 3)).astype(np.int64),
              rng.integers(-100, 100, B).astype(np.float32),
              rng.integers(-1000, 1000, (B, 8)).astype(np.int32),
              rng.random(B) < 0.3]
    leaves = [torch.from_numpy(l).to(cuda_device) for l in leaves]
    inits = [fc.monoid_identity(monoid, l.dtype) for l in leaves]
    fc.reset_launch_counts()
    got = rc.dense_monoid_table(row, leaves, [monoid] * 4, inits, S)
    assert fc.launch_counts()["dense_monoid_table"] == 1
    want = rc.dense_monoid_table_plain(row, leaves, [monoid] * 4, inits, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,one", [(262221, None), (4097, 4095),
                                   (262144, 0)])
def test_cuda_dense_table_float_sum_at_4096_slots(cuda_device, B, one):
    """One f32-sum column at S = 4096, the shared-memory path above 48 KB:
    identical bits on two calls, within rtol 1e-5 of the exact sum."""
    rng = np.random.default_rng(B)
    S = 4096
    row = rng.integers(0, S + 1, B) if one is None else np.full(B, one)
    row = torch.from_numpy(row.astype(np.int32)).to(cuda_device)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)) \
        .to(cuda_device)
    a = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    b = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    exact = rc.dense_monoid_table_plain(row, [x.double()], ["sum"], [0.0],
                                        S)[0]
    torch.testing.assert_close(a.double(), exact, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(262144, 1024), (300, 17)])
def test_cuda_dense_table_float_sum_is_deterministic(cuda_device, B, S):
    rng = np.random.default_rng(B)
    row = torch.from_numpy(rng.integers(0, S + 1, B).astype(np.int32)) \
        .to(cuda_device)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)) \
        .to(cuda_device)
    a = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    b = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = rc.dense_monoid_table_plain(row, [x], ["sum"], [0.0], S)[0]
    torch.testing.assert_close(a, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_dense_table_rejects_what_the_kernel_does_not_take(cuda_device):
    row = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(WindFlowError):
        rc.dense_monoid_table(row, [torch.zeros(8, dtype=torch.float64,
                                                device=cuda_device)],
                              ["sum"], [0.0], 4)
    with pytest.raises(WindFlowError):
        rc.dense_monoid_table(row, [torch.zeros(8, device=cuda_device)],
                              ["sum"], [0.0], 4097)
    with pytest.raises(WindFlowError):
        rc.dense_monoid_table(row.long(), [torch.zeros(8,
                                                       device=cuda_device)],
                              ["sum"], [0.0], 4)


# ---------------------------------------------------------------------------
# time-based windows on the card
# ---------------------------------------------------------------------------

#: 8 keys, 4,096 tuples a batch 10 µs apart, 4 ms windows sliding by 1 ms:
#: the first batch sizes the ring to 343 panes, 8 * 343 + 1 = 2,745 ids
TB_K, TB_CAP, TB_GAP = 8, 4096, 10


def _tb_data(n_batches, seed=31):
    rng = np.random.default_rng(seed)
    n = TB_CAP * n_batches
    keys = rng.integers(0, TB_K, n).astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    ts = np.arange(n, dtype=np.int64) * TB_GAP
    return [{"key": k, "v0": v, "ts": t}
            for k, v, t in zip(keys, vals, ts.tolist())]


def _tb_graph(items, cuda_kernels, sink_fn, sum_combiner=False):
    import windflow_tpu_torch as wt
    wb = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withTBWindows(4_000, 1_000).withKeyBy(lambda t: t["key"])
          .withMaxKeys(TB_K))
    win = (wb.withSumCombiner() if sum_combiner else wb).build()
    g = wt.PipeGraph("tb_cuda", wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT,
                     config=wt.Config(device="cuda", cuda_kernels=cuda_kernels,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(wt.Source_Builder(lambda: iter(items))
                 .withTimestampExtractor(lambda t: t["ts"])
                 .withOutputBatchSize(TB_CAP).build()) \
        .add(win).add_sink(wt.Sink_Builder(sink_fn).build())
    return g, win


def _tb_run(items, cuda_kernels):
    got = []
    g, win = _tb_graph(items, cuda_kernels, lambda r: got.append(
        (r["key"], r["wid"], r["value"])) if r is not None else None)
    g.run()
    return sorted(got), win


@pytest.mark.cuda
def test_cuda_tb_graph_under_the_kernel_gate_equals_the_kill_switch(
        cuda_device):
    items = _tb_data(5)
    on, win = _tb_run(items, "auto")
    assert win.max_keys * win.NP + 1 <= fc.MAX_BUCKETS
    off, _ = _tb_run(items, "0")
    assert on == off and len(on) > 0


@pytest.mark.cuda
def test_cuda_tb_step_launches_the_grouping_kernel(cuda_device):
    items = _tb_data(4)
    fc.reset_launch_counts()
    _, win = _tb_run(items, "auto")
    # one launch a step: the four batches' steps, then the EOS flush
    assert win._overflow_steps == 4
    assert fc.launch_counts()["grouping_rank_hist"] >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_tb_step_makes_no_host_read(cuda_device, sum_combiner):
    """One TB step, away from the 32-step checkpoint, under
    ``torch.cuda.set_sync_debug_mode("error")``: no synchronising call;
    with ``withSumCombiner`` over the f32 values, the ordered sum's
    grouping and doubling steps included."""
    from windflow_tpu_torch.batch import HostBatch, host_to_device
    items = _tb_data(3)
    g, win = _tb_graph(items, "auto", lambda r: None,
                       sum_combiner=sum_combiner)
    g._build()
    batches = []
    for i in range(3):
        chunk = items[i * TB_CAP:(i + 1) * TB_CAP]
        tss = [t["ts"] for t in chunk]
        batches.append(host_to_device(HostBatch(chunk, tss, watermark=tss[0]),
                                      TB_CAP, cuda_device,
                                      frontier=tss[-1]))
    win._step(batches[0])        # ring sizing and the kernel build
    win._step(batches[1])
    torch.cuda.synchronize()
    assert win._overflow_steps % 32 != 31
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = win._step(batches[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(out.valid.any())


# ---------------------------------------------------------------------------
# count-window steps, declared f32 sums and columnar staging on the card
# ---------------------------------------------------------------------------

#: 64 keys, 8,192 tuples a batch, count windows of 64 sliding by 16
CB_K, CB_CAP = 64, 8192


def _cb_batches(device, n, seed=51, floats=False):
    from windflow_tpu_torch.batch import columns_to_device
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = (rng.standard_normal(CB_CAP) if floats
             else rng.integers(-100, 101, CB_CAP)).astype(np.float32)
        cols = {"key": rng.integers(0, CB_K, CB_CAP).astype(np.int32),
                "v0": v}
        ts = np.arange(i * CB_CAP, (i + 1) * CB_CAP, dtype=np.int64)
        out.append(columns_to_device(cols, ts, CB_CAP, device,
                                     watermark=int(ts[-1])))
    return out


def _cb_op(sum_combiner):
    import windflow_tpu_torch as wt
    wb = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
          .withMaxKeys(CB_K))
    if sum_combiner:
        wb = wb.withSumCombiner()
    g = wt.PipeGraph("cb_cuda", config=wt.Config(device="cuda"))
    op = wb.build()
    g.add_source(wt.Source_Builder(lambda: iter(())).withOutputBatchSize(
        CB_CAP).build()).add(op).add_sink(wt.Sink_Builder(lambda t: None)
                                          .build())
    g._build()
    return op


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_cb_step_makes_no_host_read(cuda_device, sum_combiner):
    """One CB step, generic and ``withSumCombiner``, under
    ``torch.cuda.set_sync_debug_mode("error")``: no synchronising call
    (no copy of a Python scalar to the card, no host read)."""
    op = _cb_op(sum_combiner)
    batches = _cb_batches(cuda_device, 3)
    op._step(batches[0])         # state and the kernels' first build
    op._step(batches[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = op._step(batches[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(out.valid.any())


def _f32_sum_bits(op_factory, batches, step):
    """Outputs of every step of a fresh operator over ``batches``, as
    bytes."""
    op = op_factory()
    parts = []
    for b in batches:
        out = step(op, b)
        parts += [out.payload["key"], out.payload["wid"],
                  out.payload["value"], out.valid]
    torch.cuda.synchronize()
    return b"".join(p.cpu().numpy().tobytes() for p in parts)


@pytest.mark.cuda
def test_cuda_declared_f32_sums_repeat_bit_for_bit(cuda_device):
    """C2: the CB and the TB step with ``withSumCombiner`` over random
    float values give the same bits on two runs (the declared float sum
    takes no atomics)."""
    import windflow_tpu_torch as wt
    cb = _cb_batches(cuda_device, 4, floats=True)

    def cb_step(op, b):
        return op._step(b)
    assert _f32_sum_bits(lambda: _cb_op(True), cb, cb_step) \
        == _f32_sum_bits(lambda: _cb_op(True), cb, cb_step)

    def tb_op():
        win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                          lambda a, b: a + b)
               .withTBWindows(40_000, 10_000).withKeyBy(lambda t: t["key"])
               .withMaxKeys(CB_K).withSumCombiner().build())
        g = wt.PipeGraph("tb_f32", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT,
                         config=wt.Config(device="cuda"))
        g.add_source(wt.Source_Builder(lambda: iter(()))
                     .withTimestampExtractor(lambda t: 0)
                     .withOutputBatchSize(CB_CAP).build()) \
            .add(win).add_sink(wt.Sink_Builder(lambda t: None).build())
        g._build()
        return win
    for i, b in enumerate(cb):      # 8 tuples a µs: dense panes
        b.ts = b.ts // 8
        b.ts_min, b.ts_max = i * CB_CAP // 8, ((i + 1) * CB_CAP - 1) // 8
        b.watermark = b.ts_max
    assert _f32_sum_bits(tb_op, cb, cb_step) == _f32_sum_bits(tb_op, cb,
                                                              cb_step)


@pytest.mark.cuda
def test_cuda_pinned_staging_buffers_not_reused_in_flight(cuda_device):
    """Twice the pool depth of columnar batches stage behind a busy
    stream with no synchronise: every staged batch holds its own rows, so
    no pinned buffer was refilled while its copy was still queued."""
    from windflow_tpu_torch import staging
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter

    class Inbox:
        def __init__(self):
            self.got = []

        def receive(self, ch, msg):
            self.got.append(msg)
    cap = 1 << 20
    inbox = Inbox()
    em = DeviceStageEmitter([(inbox, 0)], cap, cuda_device)
    n = 2 * staging.DEFAULT_DEPTH + 1
    rng = np.random.default_rng(61)
    want = [rng.integers(0, 1 << 30, cap).astype(np.int32)
            for _ in range(n)]
    torch.cuda._sleep(200_000_000)     # hold the stream while we stage
    for i, k in enumerate(want):
        em.emit_columns({"key": k, "v0": k.astype(np.float32)},
                        np.full(cap, i, np.int64), i)
    torch.cuda.synchronize()
    assert em.packed_batches == n == len(inbox.got)
    for i, (db, k) in enumerate(zip(inbox.got, want)):
        assert np.array_equal(db.payload["key"].cpu().numpy(), k), i
        assert np.array_equal(db.payload["v0"].cpu().numpy(),
                              k.astype(np.float32)), i
        assert bool((db.ts == i).all()) and db.watermark == i
