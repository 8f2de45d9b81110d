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
scatter-add (the declared-sum reassociation tolerance).  The stateful
and key-compaction checks at the end run the dense associative step,
the compacted stateful step and the compacted count-window step with no
synchronising call, run the wavefront's device loop (a CUDA graph WHILE
node, ``kernels/loop_cuda.py``) on the dense, interned and compacted
steps with no synchronising call, hold its steering kernel against its
plain twin at depths 1, 2, 1,024, 1,025 and the capacity, refuse a
synchronising user function by name, audit a plain wavefront on the
card as WF907, and check a compacted reduce run's table-kernel launches;
the running sums are integer-valued, so exact.  The wire and megastep
checks at the end decode the 13-lane adversarial matrix on the card to
the CPU decode's bits, replay CB, TB, dense-reduce, associative,
sorted-reduce and wavefront megasteps with no synchronising call
(records equal to K = 1's and the CPU's, kernel launches counted
through replays; and a K = 8 wavefront capture, refused by name under
``cuda_kernels="0"``), count one ``cudaGraphLaunch`` a megastep, check that emitted batches never
alias the graph's outputs, recapture on a TB ring regrow, and run the
sorted and dense reduce steps with no synchronising call.  The durable
state checks round-trip the FFAT CB and TB, stateful and compacted
reduce snapshots bit for bit onto the card, step restored operators
with no synchronising call, and restore a K = 8 chaos cell to K = 1's
records.  The observability checks at the end step an untraced CB
replica (the recorder bound) and a sketched device keyby split with no
synchronising call, count the one wait of a traced batch at
``trace_device_sync_every=1``, replay a K = 8 megastep with the recorder
on as with it off (the same launches a group, one ``cudaGraphLaunch`` a
megastep, every trace's stamps in order), read nonzero allocated bytes
from the ``Device`` section, and find the traced annotation in a
``profile()`` capture.  The second half of the observability plane: a
CB and a TB replica with every plane on make no host read but the
recorder's wait and the freshness gauge's read of that waited batch; the
compacted reduce synchronises as often with every plane on as off; the
monitoring thread ticks through a K = 8 capture (each tick holds the
capture lock) with records equal to K = 1's; and the tenant ledger's
resident walk counts a storage once however many views reach it, within
the allocator's bytes.  The analysis plane's checks at the end run
``PipeGraph.check()`` on card graphs (one closing over a card tensor)
with no allocation, no kernel launch, no CUDA kernel in a profiler window
and no synchronising call; refuse the two-fault graph before any
allocation; and hold a graph's records and launches equal with
preflight on and off.  The apps and the host windows at the end: the
``ffat_analytics`` and ``market_ticker`` apps at a small size on the
card equal their CPU runs record for record (integer-valued, so exact),
the grouping kernel launched by both and the fold by the ticker; and a
time-window ``Keyed_Windows`` on the host behind a K = 8 megastep edge
fires on the watermark before end of stream, with records equal to
K = 1's and the CPU's.  The serving plane at the end: the native host
library loads on the card host; a per-replica TB ring row moved by the
reshard executor into the static carry of a captured K = 8 body replays
equal to the eager steps after the same move (and a rebinding move,
the JAX package's functional ``.at[].set``, would not); and the keyed
TB replicas' steps between executor ticks, and an in-place row move,
make no synchronising call but the move's one ring-clock read.  The host
spans at the end: a K = 8 TB capture has the same nodes with the spans
on as off, and in a ``profile()`` capture each group's ``dispatched``
stamp lies within 0.1 ms of its ``wf:megastep.launch`` span's start.
DSPBench FraudDetection's predictor at the end: at K = 8 on the card its
alerts equal the literal float64 reference's (``reference/
fraud_dspbench.py``), and its table is the operator's, updated in place.
"""

import gc

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


# ---------------------------------------------------------------------------
# whole-chain fusion and the mask-only fan-outs on the card
# ---------------------------------------------------------------------------

def _fused_tail_graph(tail, event=False):
    """Source → MapGPU → FilterGPU → ``tail`` → Sink on the card, built
    (not run): fusion installs the Map|Filter prelude on ``tail``."""
    import windflow_tpu_torch as wt
    src = wt.Source_Builder(lambda: iter(())).withOutputBatchSize(CB_CAP)
    if event:
        src = src.withTimestampExtractor(lambda t: 0)
    g = wt.PipeGraph("fused_cuda", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT if event else wt.TimePolicy.INGRESS,
                     config=wt.Config(device="cuda"))
    g.add_source(src.build()) \
        .add(wt.MapGPU_Builder(lambda t: {"key": t["key"],
                                          "v0": t["v0"] * 2.0}).build()) \
        .add(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build()) \
        .add(tail).add_sink(wt.Sink_Builder(lambda t: None).build())
    g._build()
    assert tail._fused_prelude is not None
    return tail


def _no_host_read(step, batches):
    """Two warm steps, then one under ``set_sync_debug_mode("error")``."""
    step(batches[0])
    step(batches[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(batches[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_fused_cb_step_makes_no_host_read(cuda_device, sum_combiner):
    """The fused Map|Filter|FFAT CB step, generic and
    ``withSumCombiner``: the prelude runs inside the step, which makes no
    synchronising call."""
    import windflow_tpu_torch as wt
    wb = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
          .withMaxKeys(CB_K))
    op = _fused_tail_graph((wb.withSumCombiner() if sum_combiner
                            else wb).build())
    out = _no_host_read(op._step, _cb_batches(cuda_device, 3))
    assert bool(out.valid.any())


@pytest.mark.cuda
def test_cuda_fused_tb_step_makes_no_host_read(cuda_device):
    """The fused Map|Filter|FFAT TB step, away from the 32-step
    checkpoint (the first step's ring sizing reads the device, on
    purpose)."""
    import windflow_tpu_torch as wt
    op = _fused_tail_graph(
        wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
        .withTBWindows(400, 100).withKeyBy(lambda t: t["key"])
        .withMaxKeys(CB_K).build(), event=True)
    batches = _cb_batches(cuda_device, 3)
    for i, b in enumerate(batches):      # 8 tuples a µs
        b.ts = b.ts // 8
        b.ts_min, b.ts_max = i * CB_CAP // 8, ((i + 1) * CB_CAP - 1) // 8
        b.watermark = b._frontier = b.ts_max
    out = _no_host_read(op._step, batches)
    assert op._overflow_steps == 3
    assert bool(out.valid.any())


@pytest.mark.cuda
def test_cuda_device_keyby_split_makes_no_host_read(cuda_device):
    """``DeviceKeyByEmitter.split`` on the card: one mask a destination,
    no synchronising call, and the masks partition the valid lanes by the
    host's splitmix64 placement."""
    from windflow_tpu_torch.parallel import emitters as te
    em = te.DeviceKeyByEmitter([(None, 0)] * 4, lambda t: t["key"])
    batches = _cb_batches(cuda_device, 3)
    keys, masks = _no_host_read(em.split, batches)
    b = batches[2]
    total = torch.stack(masks).to(torch.int32).sum(0)
    assert torch.equal(total, b.valid.to(torch.int32))
    k = b.payload["key"].cpu().numpy()
    dest = torch.stack(masks).to(torch.int64).argmax(0).cpu().numpy()
    want = (te.splitmix64_np(k) % np.uint64(4)).astype(np.int64)
    assert np.array_equal(dest, want)


@pytest.mark.cuda
def test_cuda_device_split_makes_no_host_read(cuda_device):
    """The device ``SplittingEmitter``: a torch split function takes the
    mask-only route (probed once on meta tensors), with no synchronising
    call on the batch."""
    from windflow_tpu_torch.parallel.emitters import SplittingEmitter

    class Branch:
        def __init__(self):
            self.got = []

        def emit_device_batch(self, batch):
            self.got.append(batch)
    branches = [Branch(), Branch()]
    em = SplittingEmitter(lambda t: t["key"] & 1, branches)
    batches = _cb_batches(cuda_device, 3)
    _no_host_read(em.emit_device_batch, batches)
    assert list(em._device_split.values()) == [True]
    b0, b1 = branches[0].got[2], branches[1].got[2]
    # both branches hold the same buffers, each with its own mask
    assert b0.payload["key"] is b1.payload["key"]
    k = batches[2].payload["key"]
    assert torch.equal(b0.valid, (k & 1) == 0)
    assert torch.equal(b1.valid, (k & 1) == 1)


# ---------------------------------------------------------------------------
# stateful operators and key compaction on the card
# ---------------------------------------------------------------------------

def _op_graph(op, compact=True):
    """Source → ``op`` → Sink, built on the card (no run): the graph
    attaches what ``Config.key_compaction`` gives ``op``."""
    import windflow_tpu_torch as wt
    g = wt.PipeGraph("op_cuda", config=wt.Config(device="cuda",
                                                 key_compaction=compact))
    g.add_source(wt.Source_Builder(lambda: iter(())).withOutputBatchSize(
        CB_CAP).build()).add(op).add_sink(wt.Sink_Builder(lambda t: None)
                                          .build())
    g._build()
    return op


def _stateful_op(dense, assoc):
    import windflow_tpu_torch as wt
    b = (wt.MapGPU_Builder(
            lambda t, s: ({"key": t["key"], "v0": s + t["v0"]}, s + t["v0"]))
         .withKeyBy(lambda t: t["key"]).withInitialState(np.float32(0.0))
         .withNumKeySlots(CB_K))
    if dense:
        b = b.withDenseKeys()
    if assoc:
        b = b.withAssociativeUpdate(
            lift=lambda t: t["v0"], comb=lambda a, b: a + b,
            project=lambda t, s: {"key": t["key"], "v0": s})
    return _op_graph(b.build())


def _running_sum_check(op, batches, out):
    """The last batch's outputs are the per-key running sums over every
    batch stepped so far (integer-valued f32: exact)."""
    keys = np.concatenate([b.payload["key"].cpu().numpy() for b in batches])
    vals = np.concatenate([b.payload["v0"].cpu().numpy() for b in batches])
    order = np.argsort(keys, kind="stable")
    run = np.empty_like(vals)
    sk, sv = keys[order], vals[order].astype(np.float64)
    starts = np.r_[True, sk[1:] != sk[:-1]]
    cs = np.cumsum(sv)
    base = np.maximum.accumulate(np.where(starts, np.arange(len(sk)), 0))
    run[order] = cs - np.r_[0.0, cs][base]
    want = run[-CB_CAP:]
    assert np.array_equal(out.payload["v0"].cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_dense_assoc_stateful_step_makes_no_host_read(cuda_device):
    """The dense-keys associative step (the segmented scan) under
    ``set_sync_debug_mode("error")``: no synchronising call."""
    op = _stateful_op(dense=True, assoc=True)
    batches = _cb_batches(cuda_device, 3)
    out = _no_host_read(op._step, batches)
    _running_sum_check(op, batches, out)


@pytest.mark.cuda
def test_cuda_compacted_stateful_step_makes_no_host_read(cuda_device):
    """The compacted stateful step (host-fed, key compaction on; the
    associative body): the remap lookup, the stats update and the body
    make no synchronising call once the keys are admitted."""
    op = _stateful_op(dense=False, assoc=True)
    assert op._compactor is not None
    batches = _cb_batches(cuda_device, 3)
    op._compactor.observe(np.arange(CB_K))
    out = _no_host_read(op._step, batches)
    assert op._compactor.summary()["hit_rate"] == 1.0
    assert len(op._interner) == 0
    _running_sum_check(op, batches, out)


def _wavefront_op(route):
    """The running-sum wavefront (no associative update) over CB_K keys:
    dense keys, interned, or compacted (host-fed, key compaction on)."""
    import windflow_tpu_torch as wt
    b = (wt.MapGPU_Builder(
            lambda t, s: ({"key": t["key"], "v0": s + t["v0"]}, s + t["v0"]))
         .withKeyBy(lambda t: t["key"]).withInitialState(np.float32(0.0))
         .withNumKeySlots(CB_K).withName("wave"))
    if route == "dense":
        b = b.withDenseKeys()
    return _op_graph(b.build(), compact=route == "compacted")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "interned", "compacted"])
def test_cuda_wavefront_steps_make_no_host_read(cuda_device, route):
    """The wavefront's device loop (a CUDA graph WHILE node) on each key
    route: the dense step, the interning route's step function (its
    per-batch key read happens before it, by design) and the compacted
    step (keys admitted beforehand) make no synchronising call under
    ``set_sync_debug_mode("error")``, launch the loop once a step, and
    give the per-key running sums; the depth stays on the card."""
    from windflow_tpu_torch.batch import DeviceBatch
    from windflow_tpu_torch.kernels import loop_cuda
    op = _wavefront_op(route)
    batches = _cb_batches(cuda_device, 3)
    if route == "compacted":
        assert op._compactor is not None
        op._compactor.observe(np.arange(CB_K))
    op._step(batches[0])
    op._step(batches[1])
    if route != "interned":
        step, arg = op._step, batches[2]
    else:
        assert op._compactor is None and not op.dense_keys
        # the intern read runs before the strict window

        def step(arg):
            batch, (keys, uk, us) = arg
            op._state, pay, ok = op._get_step(CB_CAP)(
                op._state, batch.payload, batch.valid, keys, uk, us)
            return DeviceBatch(pay, batch.ts, ok)
        arg = (batches[2], op._intern_batch(batches[2]))
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(arg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert fc.launch_counts()["wavefront_loop"] == 1
    body = next(iter(op._bodies.values()))
    assert isinstance(body.last_depth, torch.Tensor)
    assert body.last_depth.is_cuda
    assert op.last_depth > 1 and loop_cuda.device_passes(cuda_device) > 0
    _running_sum_check(op, batches, out)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 1024, 1025, "capacity"])
def test_cuda_wavefront_advance_matches_its_plain_twin(cuda_device, depth):
    """The steering kernel, launched eagerly pass by pass, writes the
    plain twin's cursor (slice, class, more) on counts of depth 1, 2,
    1,024, 1,025 and the capacity; inside a captured WHILE node the loop
    runs exactly ``depth`` passes and each class body sees its rank's
    slice."""
    from windflow_tpu_torch.kernels import loop_cuda as L
    cap = 4096
    d = cap if depth == "capacity" else depth
    rng = np.random.default_rng(d)
    counts = np.sort(rng.integers(1, 300, d))[::-1].astype(np.int32)
    counts[0] = 300
    cnt_h = torch.zeros(cap, dtype=torch.int32)
    cnt_h[:d] = torch.from_numpy(counts.copy())
    widths = L.width_classes(300, cap)
    cnt = cnt_h.to(cuda_device)
    cur = torch.zeros(L.CUR_WORDS, dtype=torch.int64, device=cuda_device)
    cur_h = torch.zeros(L.CUR_WORDS, dtype=torch.int64)
    L.prepare(cuda_device)
    L.wavefront_advance(cnt, cur, widths, True)
    L.advance_plain(cnt_h, cur_h, widths, True)
    passes = 0
    while True:
        assert cur.cpu().tolist() == cur_h.tolist()
        if not int(cur_h[4]):
            break
        L.wavefront_advance(cnt, cur, widths, False)
        L.advance_plain(cnt_h, cur_h, widths, False)
        passes += 1
    assert passes == d
    log = torch.zeros((cap + 1, 3), dtype=torch.int64, device=cuda_device)

    def body(width):
        row = (cur[0] - 1).clamp(min=0).reshape(1)
        w = torch.full((), width, dtype=torch.int64, device=cuda_device)
        log.index_copy_(0, row, torch.stack([cur[2], cur[3], w])
                        .reshape(1, 3))
    cur.zero_()
    for width in widths:
        body(width)
    g = fc.CountedGraph(torch.cuda.CUDAGraph())
    with g.capture(L.side_capture(g.graph, cuda_device)):
        log.zero_()
        L.emit_loop(cnt, cur, widths, body)
    L.reset_device_passes(cuda_device)
    fc.reset_launch_counts()
    g.replay()
    torch.cuda.synchronize()
    assert L.device_passes(cuda_device) == d
    assert fc.launch_counts()["wavefront_loop"] == 1
    off = np.r_[0, np.cumsum(counts)[:-1]]
    want = np.stack([off, counts, [widths[L.pick_class(widths, int(c))]
                                   for c in counts]], 1)
    assert np.array_equal(log[:d].cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_wavefront_fn_that_synchronises_raises_naming_it(cuda_device):
    """A user function that reads a tensor on the host cannot ride the
    device loop: the first step raises WindFlowError naming the
    operator, never falling back to the plain loop."""
    import windflow_tpu_torch as wt
    op = _op_graph(
        wt.MapGPU_Builder(lambda t, s: ({"key": t["key"],
                                         "v0": s + float(t["v0"][0])},
                                        s + t["v0"]))
        .withKeyBy(lambda t: t["key"]).withInitialState(np.float32(0.0))
        .withNumKeySlots(CB_K).withDenseKeys().withName("syncing").build())
    with pytest.raises(wt.WindFlowError, match="syncing"):
        op._step(_cb_batches(cuda_device, 1)[0])


@pytest.mark.cuda
def test_cuda_audit_wf907_on_a_plain_wavefront(cuda_device, monkeypatch):
    """With the kernels on, the dense wavefront's first recorded step
    launches the loop and audits clean; with its route forced to the
    plain host loop while the gate holds, the step launches no loop and
    is WF907 naming ``wavefront_loop`` (and WF902/WF906 for the plain
    loop's read of the rank counts, which no sanctioned read covers any
    more), with the same records."""
    from windflow_tpu_torch.analysis import ir_audit
    from windflow_tpu_torch.kernels import ffat_cuda
    from windflow_tpu_torch.ops import gpu_stateful as gst
    outs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(
                gst, "_loop_route",
                lambda kernels, dev: ffat_cuda._gate("wavefront_loop",
                                                     kernels) and False)
        op = _wavefront_op("dense")
        rep = op.replicas[0]
        rep.emitter = _Collect()
        batch = _cb_batches(cuda_device, 1)[0]
        rep.process_device_batch(batch)
        torch.cuda.synchronize()
        (facts,) = op._audit_programs[op.name].values()
        found = ir_audit.program_findings(op.name, facts)
        if plain:
            assert sorted(d.code for d in found) == [
                "WF902", "WF906", "WF907"]
            assert "wavefront_loop" in next(
                d for d in found if d.code == "WF907").message
        else:
            assert found == [] and facts["launches_by_kernel"][
                "wavefront_loop"] == 1
        outs.append(rep.emitter.out[0].payload["v0"].cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_cuda_compacted_cb_step_makes_no_host_read(cuda_device):
    """The compacted FFAT CB step (``withCompactedKeys``): lookup, stats,
    the window kernels and the inverse remap of the output keys make no
    synchronising call; the output carries the user's keys."""
    import windflow_tpu_torch as wt
    op = _op_graph(wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                              lambda a, b: a + b)
                   .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
                   .withCompactedKeys().withSumCombiner().build())
    assert op._compactor is not None and op.max_keys == 1024
    batches = _cb_batches(cuda_device, 3)
    for b in batches:              # user keys far from the slots
        b.payload["key"] = b.payload["key"] * 1000 + 7
    op._compactor.observe(np.arange(CB_K) * 1000 + 7)
    fc.reset_launch_counts()
    out = _no_host_read(op._step, batches)
    assert fc.launch_counts()["sliding_fold"] == 3
    keys = out.payload["key"][out.valid].cpu().numpy()
    assert keys.size and set(keys.tolist()) <= set(range(7, CB_K * 1000, 1000))


@pytest.mark.cuda
def test_cuda_compacted_reduce_run_launches_the_table_kernel(cuda_device):
    """A graph run of the unbounded compacted reduce with
    ``cuda_kernels="auto"``: ``dense_monoid_table`` launches every batch
    and the records equal the kill switch's and the numpy oracle."""
    import windflow_tpu_torch as wt
    rng = np.random.default_rng(8)
    n, cap = 4 * CB_CAP, CB_CAP
    keys = (rng.integers(0, 300, n) * 7919 + 13).astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    items = [{"key": k, "v0": v} for k, v in zip(keys, vals)]

    def run(cuda_kernels):
        got = []
        op = (wt.ReduceGPU_Builder(
                lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                              "v0": torch.maximum(a["v0"], b["v0"])})
              .withKeyBy(lambda t: t["key"]).withMonoidCombiner("max")
              .build())
        g = wt.PipeGraph("red_cuda", config=wt.Config(
            device="cuda", cuda_kernels=cuda_kernels,
            punctuation_interval_usec=10 ** 12))
        g.add_source(wt.Source_Builder(lambda: iter(items))
                     .withOutputBatchSize(cap).build()).add(op).add_sink(
            wt.Sink_Builder(lambda r: got.append(
                (int(r["key"]), float(r["v0"]))) if r else None).build())
        fc.reset_launch_counts()
        g.run()
        return got, fc.launch_counts()["dense_monoid_table"], op
    got, launched, op = run("auto")
    ref, none, _ = run("0")
    assert launched == n // cap and none == 0
    assert got == ref
    assert op._compactor is not None and not op._compactor.bounded
    want = []
    for lo in range(0, n, cap):
        k, v = keys[lo:lo + cap], vals[lo:lo + cap]
        for u in np.unique(k):
            want.append((int(u), float(v[k == u].max())))
    assert got == want


# ---------------------------------------------------------------------------
# the wire decode and the megastep's captured groups on the card
# ---------------------------------------------------------------------------

_WRNG = np.random.default_rng(0)
_WCAP = 2048
#: tests/test_wire.py's adversarial matrix (the same seed and draws; this
#: file imports no JAX, so the matrix is built here again)
WIRE_LANES = {
    "constant_i32": np.full(_WCAP, -7, np.int32),
    "all_null_i32": np.zeros(_WCAP, np.int32),
    "all_null_f32": np.zeros(_WCAP, np.float32),
    "random_i32": _WRNG.integers(-2**31, 2**31, _WCAP).astype(np.int32),
    "random_f32": _WRNG.random(_WCAP, dtype=np.float32),
    "nan_inf_f32": np.tile(np.array([np.nan, np.inf, -np.inf, -0.0],
                                    np.float32), _WCAP // 4),
    "low_card_i32": _WRNG.integers(0, 61, _WCAP).astype(np.int32),
    "sorted_gaps_i64": np.sort(
        _WRNG.integers(0, 10**9, _WCAP)).astype(np.int64),
    "cadence_i64": np.arange(_WCAP, dtype=np.int64) * 1_000 + 5,
    "extremes_i64": np.tile(np.array(
        [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1],
        np.int64), _WCAP // 4),
    "extremes_i32": np.tile(np.array(
        [np.iinfo(np.int32).min, np.iinfo(np.int32).max], np.int32),
        _WCAP // 2),
    "big_u64": _WRNG.integers(0, 2**63, _WCAP).astype(np.uint64)
    + np.uint64(2**63 - 1),
    "uint32_full": _WRNG.integers(0, 2**32, _WCAP).astype(np.uint32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIRE_LANES))
def test_cuda_wire_decode_equals_the_cpu_decode(cuda_device, name):
    """Every adversarial lane's wire words decode on the card to the CPU
    decode's bits and the input's (the int64 cumsum of delta/delta2 wraps
    two's-complement on the card too: ``extremes_i64``, ``big_u64``)."""
    from windflow_tpu_torch import staging, wire
    lane = WIRE_LANES[name]
    dt = str(lane.dtype)
    tss = np.arange(_WCAP, dtype=np.int64) * 17
    b = staging.PackedBatchBuilder((dt,), _WCAP)
    b.append([lane], tss)
    wbuf, fmt = wire.WireEncoder((dt,), _WCAP, reseed_every=4).encode(
        b.finish().copy())
    if fmt is None:
        pytest.skip(f"{name}: compression lost, the logical buffer ships")
    words = torch.from_numpy(wbuf.view(np.int32))
    dec = wire.build_wire_decode(fmt, (dt,), _WCAP)
    cpu = dec(words)
    card = dec(words.to(cuda_device))
    torch.cuda.synchronize()
    for c, g in zip(cpu, card):
        assert c.dtype == g.dtype
        assert np.array_equal(c.numpy().view(np.uint8),
                              g.cpu().numpy().view(np.uint8)), name
    assert np.array_equal(card[0].cpu().numpy().view(np.uint8),
                          lane.view(np.uint8))
    assert np.array_equal(card[1].cpu().numpy(), tss)


#: megastep runs on the card: frames of MS_N tuples, batches of MS_CAP
MS_N, MS_CAP, MS_KEYS = 16 * 4096, 4096, 64


def _ms_blob(gaps=None, seed=71, n=MS_N):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    rec["k"] = rng.integers(0, MS_KEYS, n)
    rec["ts"] = np.arange(n, dtype=np.int64) * 50 if gaps is None \
        else np.cumsum(gaps)
    rec["v"] = rng.integers(-100, 101, n)
    return rec.tobytes()


def _ms_tail(family):
    import windflow_tpu_torch as wt
    if family == "cb":
        return (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"],
                                           lambda a, b: a + b)
                .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
                .withMaxKeys(MS_KEYS).withName("w").build())
    if family == "tb":
        return (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"],
                                           lambda a, b: a + b)
                .withTBWindows(40_000, 10_000).withKeyBy(lambda t: t["key"])
                .withMaxKeys(MS_KEYS).withName("w").build())
    if family == "dense":
        return (wt.ReduceGPU_Builder(lambda a, b: a)
                .withKeyBy(lambda t: t["key"]).withMaxKeys(MS_KEYS)
                .withSumCombiner().withName("w").build())
    if family == "sorted":
        return (wt.ReduceGPU_Builder(
                    lambda a, b: {"key": a["key"], "v": a["v"] + b["v"]})
                .withKeyBy(lambda t: t["key"]).withName("w").build())
    if family == "wavefront":
        return (wt.MapGPU_Builder(
                    lambda t, s: ({"key": t["key"], "v": s["acc"] + t["v"]},
                                  {"acc": s["acc"] + t["v"]}))
                .withName("w").withKeyBy(lambda t: t["key"])
                .withInitialState({"acc": np.float32(0.0)})
                .withNumKeySlots(MS_KEYS).withDenseKeys().build())
    return (wt.MapGPU_Builder(lambda t, s: (t, s)).withName("w")
            .withKeyBy(lambda t: t["key"])
            .withInitialState({"acc": np.float32(0.0)})
            .withNumKeySlots(MS_KEYS).withDenseKeys()
            .withAssociativeUpdate(
                lift=lambda t: {"acc": t["v"]},
                comb=lambda a, b: {"acc": a["acc"] + b["acc"]},
                project=lambda t, s: {"key": t["key"], "v": s["acc"]})
            .build())


def _ms_run(family, k, device="cuda", wire=False, gaps=None, tap=None,
            n=MS_N, **cfg):
    """FrameSource → one foldable tail → Sink at ``megastep_sweeps=k``:
    (sorted records, Megastep section, graph).  ``tap(graph)`` runs after
    the build, before the first batch; ``n`` records (MS_N: 16 batches);
    ``cfg`` are more Config fields."""
    import windflow_tpu_torch as wt
    out = []
    blob = _ms_blob(gaps, n=n)
    step = MS_CAP * 24 * 3 // 2

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    src = wt.FrameSource(chunks, nv=1, fields=["v"],
                         output_batch_size=MS_CAP,
                         record_spec={"key": np.int32(0),
                                      "v": np.float32(0.0)})
    g = wt.PipeGraph("ms_cuda", time_policy=wt.TimePolicy.EVENT,
                     config=wt.Config(device=device, megastep_sweeps=k,
                                      wire_compression=wire,
                                      key_compaction=False,
                                      punctuation_interval_usec=10 ** 12,
                                      **cfg))
    g.add_source(src).add(_ms_tail(family)).add_sink(wt.Sink_Builder(
        lambda r: out.append(tuple(sorted(
            (n, np.asarray(v).item()) for n, v in r.items())))
        if r is not None else None).build())
    if tap is not None:
        g.start()
        tap(g)
        g.wait_end()
    else:
        g.run()
    torch.cuda.synchronize()
    return sorted(out), g.stats()["Megastep"], g


def _strict_replays(monkeypatch):
    """Run every group whose graph is already captured under
    ``set_sync_debug_mode("error")``: copy-in, the super-buffer copy, the
    replay and the drain's clones make no synchronising call.  The
    emission downstream (a record sink copies to the host) and the
    cadence hooks run outside it.  Returns the count of such groups."""
    from windflow_tpu_torch import megastep as ms
    orig = ms.MegastepEdge.run
    seen = [0]

    def relaxed(fn):
        def call(self, *args):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(self, *args)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call
    monkeypatch.setattr(ms.MegastepEdge, "_emit",
                        relaxed(ms.MegastepEdge._emit))
    monkeypatch.setattr(ms.MegastepEdge, "_post_hooks",
                        relaxed(ms.MegastepEdge._post_hooks))

    def run(self):
        q = self._q
        cached = (len(q) >= self.k and self._group is not None
                  and self._group_step is self._step(q[0].capacity)
                  and self._group_sig == self._sig(q[0])
                  and not self.rep.inbox and not self.rep.done)
        if not cached:
            return orig(self)
        torch.cuda.set_sync_debug_mode("error")
        try:
            orig(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen[0] += 1
    monkeypatch.setattr(ms.MegastepEdge, "run", run)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["cb", "tb", "dense", "assoc", "sorted",
                                    "wavefront"])
@pytest.mark.parametrize("wire", [False, True])
def test_cuda_megastep_replays_sync_free_and_equals_k1(cuda_device,
                                                       monkeypatch, family,
                                                       wire):
    """A CB, a TB, a dense-reduce, an associative and a sorted-reduce
    megastep at K = 4 on the card, wire off and on: every group after the
    capture replays with no synchronising call, the records equal K = 1's
    and the CPU's, each kernel launches as often as at K = 1 (replays
    counted, the capture's warm-up not), and the counts add up."""
    fc.reset_launch_counts()
    base, _, _ = _ms_run(family, 1, wire=wire)
    launches1 = fc.launch_counts()
    seen = _strict_replays(monkeypatch)
    fc.reset_launch_counts()
    got, sec, _ = _ms_run(family, 4, wire=wire)
    launches4 = fc.launch_counts()
    e = sec["edges"][0]
    assert base and got == base
    assert e["megasteps"] >= 2 and seen[0] >= 1 and e["captures"] == 1
    assert e["batches"] + e["warmup_batches"] + e["fallback_batches"] \
        == MS_N // MS_CAP
    assert launches4 == launches1
    # the hand kernels of the route run inside the replays (the TB ring's
    # 64-key (key, pane) ids are beyond the grouping kernel's gate: no
    # kernel on that route at this shape)
    if family in ("cb", "dense", "wavefront"):
        assert e["kernel_launches_per_group"] > 0
    cpu, _, _ = _ms_run(family, 4, device="cpu", wire=wire)
    assert cpu == base


@pytest.mark.cuda
def test_cuda_k8_capture_of_a_wavefront_tail(cuda_device, monkeypatch):
    """The dense wavefront as a K = 8 megastep tail: the plane folds it
    (no refusal), one capture holds eight WHILE nodes, every cached group
    replays with no synchronising call, the loop launches once a logical
    batch as at K = 1, and the records equal K = 1's and the CPU's; under
    ``cuda_kernels="0"`` the plane refuses it by name and the records
    are the same."""
    fc.reset_launch_counts()
    base, _, _ = _ms_run("wavefront", 1)
    launches1 = fc.launch_counts()
    seen = _strict_replays(monkeypatch)
    fc.reset_launch_counts()
    got, sec, _ = _ms_run("wavefront", 8)
    e = sec["edges"][0]
    assert sec["refused"] == [] and e["kind"] == "stateful"
    assert e["megasteps"] >= 1 and seen[0] >= 0 and e["captures"] == 1
    assert e["kernel_launches_per_group"] == 8
    assert fc.launch_counts()["wavefront_loop"] \
        == launches1["wavefront_loop"] == MS_N // MS_CAP
    assert base and got == base
    off, osec, _ = _ms_run("wavefront", 8, cuda_kernels="0")
    assert off == base and osec["edges"] == []
    assert "cuda_kernels='0'" in osec["refused"][0]["reason"]
    cpu, _, _ = _ms_run("wavefront", 8, device="cpu")
    assert cpu == base


@pytest.mark.cuda
def test_cuda_one_graph_launch_per_megastep(cuda_device):
    """``torch.profiler`` sees exactly one ``cudaGraphLaunch`` per
    megastep of the run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, sec, _ = _ms_run("cb", 4)
    launches = sum(1 for ev in prof.events()
                   if ev.name == "cudaGraphLaunch")
    assert sec["edges"][0]["megasteps"] >= 2
    assert launches == sec["edges"][0]["megasteps"]


@pytest.mark.cuda
def test_cuda_megastep_outputs_do_not_alias_the_graph(cuda_device):
    """Every batch a group emits is its own memory: the first group's
    records, snapshotted at emission, are unchanged after the later
    replays overwrote the graph's outputs."""
    from windflow_tpu_torch.utils.tree import tree_leaves
    kept = []

    def tap(g):
        rep = g.pipes[0].operators[1].replicas[0]
        em = rep.emitter
        orig = em.emit_device_batch

        def emit(batch):
            leaves = tree_leaves(batch.payload) + [batch.ts, batch.valid]
            kept.append((leaves, [t.clone() for t in leaves]))
            orig(batch)
        em.emit_device_batch = emit
    _, sec, g = _ms_run("cb", 4, tap=tap)
    e = sec["edges"][0]
    assert e["megasteps"] >= 2 and len(kept) >= e["batches"]
    for leaves, snaps in kept:
        for t, s in zip(leaves, snaps):
            assert torch.equal(t, s)


@pytest.mark.cuda
def test_cuda_tb_ring_regrow_recaptures_records_equal(cuda_device):
    """A stream whose time spread grows mid-run regrows the TB ring: the
    step is rebuilt and the group recaptured, and the records equal
    K = 1's and the CPU's."""
    gaps = np.r_[np.full(MS_N // 2, 50), np.full(MS_N // 2, 2_000)]
    base, _, _ = _ms_run("tb", 1, gaps=gaps)
    got, sec, g = _ms_run("tb", 4, gaps=gaps)
    e = sec["edges"][0]
    assert base and got == base
    assert e["captures"] >= 2 and e["megasteps"] >= 1
    cpu, _, _ = _ms_run("tb", 4, device="cpu", gaps=gaps)
    assert cpu == base


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sorted", "dense"])
def test_cuda_reduce_step_makes_no_host_read(cuda_device, route):
    """The sorted and the dense ``ReduceGPU`` steps under
    ``set_sync_debug_mode("error")``: no synchronising call (both run
    inside captured megastep groups)."""
    import windflow_tpu_torch as wt
    b = wt.ReduceGPU_Builder(
        lambda a, c: {"key": a["key"], "v0": a["v0"] + c["v0"]}) \
        .withKeyBy(lambda t: t["key"])
    if route == "dense":
        b = b.withMaxKeys(CB_K).withSumCombiner()
    op = _op_graph(b.build(), compact=False)
    batches = _cb_batches(cuda_device, 3)
    out = _no_host_read(op._step, batches)
    keys = batches[2].payload["key"].cpu().numpy()
    vals = batches[2].payload["v0"].cpu().numpy()
    want = np.bincount(keys, weights=vals, minlength=CB_K)
    got_k = out.payload["key"][out.valid].cpu().numpy()
    got_v = out.payload["v0"][out.valid].cpu().numpy()
    if route == "dense":
        got_k = np.nonzero(out.valid.cpu().numpy())[0]
    assert np.array_equal(got_v, want[got_k].astype(np.float32))


# ---------------------------------------------------------------------------
# durable state on the card: snapshot -> restore round trips
# ---------------------------------------------------------------------------

def _leaves(tree):
    from windflow_tpu_torch.utils.tree import tree_flatten
    return tree_flatten(tree)[0]


def _same_host_leaves(a, b):
    """Checkpoint blobs equal leaf by leaf (numpy: dtype, shape, bits)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_host_leaves(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def _tb_batches(device, n=3):
    from windflow_tpu_torch.batch import HostBatch, host_to_device
    items = _tb_data(n)
    out = []
    for i in range(n):
        chunk = items[i * TB_CAP:(i + 1) * TB_CAP]
        tss = [t["ts"] for t in chunk]
        out.append(host_to_device(HostBatch(chunk, tss, watermark=tss[0]),
                                  TB_CAP, device, frontier=tss[-1]))
    return out


def _tb_op():
    g, win = _tb_graph(_tb_data(1), "auto", lambda r: None)
    g._build()
    return win


def _compacted_reduce_op():
    import windflow_tpu_torch as wt
    op = _op_graph(wt.ReduceGPU_Builder(
        lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                      "v0": torch.maximum(a["v0"], b["v0"])})
        .withKeyBy(lambda t: t["key"]).withMonoidCombiner("max").build())
    op._compactor.observe(np.arange(CB_K) * 1000 + 7)
    return op


def _durable_case(name, device):
    """(operator factory, three batches, the live-state getter) of one
    snapshot family."""
    if name == "cb":
        return lambda: _cb_op(False), _cb_batches(device, 3), \
            lambda op: op._states
    if name == "tb":
        return _tb_op, _tb_batches(device), lambda op: op._states
    if name == "stateful":
        return lambda: _stateful_op(dense=True, assoc=True), \
            _cb_batches(device, 3), lambda op: op._state
    batches = _cb_batches(device, 3)
    for b in batches:
        b.payload["key"] = b.payload["key"] * 1000 + 7
    return _compacted_reduce_op, batches, lambda op: op._dropped


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cb", "tb", "stateful", "compacted"])
def test_cuda_snapshot_restore_round_trips_bit_exact(cuda_device, name):
    """FFAT CB and TB, the dense stateful table and the compacted reduce:
    ``snapshot_state`` after two steps holds numpy only; restored into a
    fresh operator the state lives on ``cuda`` with the same bits, its
    own snapshot equals the blob, and the next step's output equals the
    original operator's bit for bit."""
    make, batches, live = _durable_case(name, cuda_device)
    op = make()
    for b in batches[:2]:
        op._step(b)
    blob = op.snapshot_state()
    assert not any(isinstance(x, torch.Tensor) for x in _leaves(blob))
    op2 = make()
    op2.restore_state(blob)
    if name != "compacted":
        a, b = _leaves(live(op)), _leaves(live(op2))
        assert all(t.device.type == "cuda" for t in b)
        assert all(torch.equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b))
    else:
        assert op2._compactor.export_mapping() == \
            op._compactor.export_mapping()
    _same_host_leaves(op2.snapshot_state(), blob)
    o1, o2 = op._step(batches[2]), op2._step(batches[2])
    for x, y in zip(_leaves((o1.payload, o1.ts, o1.valid)),
                    _leaves((o2.payload, o2.ts, o2.valid))):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cb", "tb", "stateful", "compacted"])
def test_cuda_restored_steps_make_no_host_read(cuda_device, name):
    """The steps between two checkpoints: an operator restored from a
    checkpoint blob steps with no synchronising call (the blob's one
    device-to-host copy is taken at the checkpoint, the restore's copy
    to the card before the first step)."""
    make, batches, _ = _durable_case(name, cuda_device)
    op = make()
    op._step(batches[0])
    op2 = make()
    op2.restore_state(op.snapshot_state())
    out = _no_host_read(op2._step, batches)
    assert bool(out.valid.any())


@pytest.mark.cuda
def test_cuda_checkpoint_between_k8_megasteps_restores_equal_to_k1(
        cuda_device, tmp_path):
    """A Kafka-fed CB chaos cell on the card at K = 8 (wire on): every
    checkpoint quiesce lands between megasteps, a mid-epoch kill and
    restore replays, and the output equals the uninterrupted K = 1
    run's record for record."""
    from windflow_tpu_torch.durability import chaos
    kw = dict(n=64 * 1024, keys=64, output_batch_size=1024,
              epoch_sweeps=8, device="cuda", wire_compression=True)
    base = chaos.make_cell("window_cb", str(tmp_path / "k1"),
                           megastep_sweeps=1, **kw)
    gb = chaos.run_baseline(base["factory"])
    assert gb.stats()["Megastep"]["k"] == 1
    chal = chaos.make_cell("window_cb", str(tmp_path / "k8"),
                           megastep_sweeps=8, **kw)
    gc = chaos.run_killed_and_restored(
        chal["factory"], chaos.KillSpec("mid_epoch", after=3))
    ms = gc.stats()["Megastep"]
    assert ms["k"] == 8 and gc.config.durability_epoch_sweeps == 1
    assert gc.stats()["Durability"]["restored_epoch"] is not None
    assert chaos.diff_records(base["read"](), chal["read"]()) is None


@pytest.mark.cuda
def test_cuda_capture_survives_a_dead_graph_in_a_cycle(cuda_device):
    """A captured graph left in a reference cycle is freed by the
    collector, and its reset inside another capture would invalidate
    that capture: ``CountedGraph.capture`` collects first and holds the
    automatic collector off, so a capture with the collector firing on
    every allocation still succeeds."""
    import gc
    x = torch.arange(8, dtype=torch.float32, device=cuda_device)
    dead = fc.CountedGraph(torch.cuda.CUDAGraph())
    with dead.capture(torch.cuda.graph(dead.graph)):
        x + 1
    cycle = {"graph": dead}
    cycle["self"] = cycle
    del dead, cycle
    old = gc.get_threshold()
    try:
        live = fc.CountedGraph(torch.cuda.CUDAGraph())
        with live.capture(torch.cuda.graph(live.graph)):
            y = x * 2
            gc.set_threshold(1)             # collect on every allocation
            [[i] for i in range(1000)]
        assert gc.isenabled()
        live.replay()
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2)


# ---------------------------------------------------------------------------
# the analysis plane: preflight at start()
# ---------------------------------------------------------------------------

def _an_graph(cuda_device, sink, lut=None, **cfg):
    """Source (record spec) → MapGPU | FilterGPU → keyed count windows
    (generic combiner) → columnar Sink, 4 batches of 4,096 on the card;
    ``lut``: the map adds a card tensor it closes over."""
    import windflow_tpu_torch as wt
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 64, 16384).astype(np.int32)
    vals = rng.integers(-100, 101, 16384).astype(np.float32)

    def gen():
        yield from ({"key": k, "v0": v} for k, v in zip(keys, vals))

    if lut is None:
        def fn(t):
            return {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}
    else:
        def fn(t):
            return {"key": t["key"], "v0": t["v0"] + lut[t["key"] % 8]}
    g = wt.PipeGraph("an", config=wt.Config(device="cuda", **cfg))
    p = g.add_source(wt.Source_Builder(gen).withOutputBatchSize(4096)
                     .withRecordSpec({"key": np.int32(0),
                                      "v0": np.float32(0.0)}).build())
    p.add(wt.MapGPU_Builder(fn).build())
    p.chain(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    p.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
          .withMaxKeys(64).build()).add_sink(
        wt.Sink_Builder(sink).withColumnarSink().build())
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("closure", [False, True])
def test_cuda_check_makes_no_device_work(cuda_device, closure):
    from torch.profiler import ProfilerActivity, profile
    lut = torch.arange(8, dtype=torch.float32, device=cuda_device) \
        if closure else None
    g = _an_graph(cuda_device, lambda c: None, lut=lut)
    gc.collect()        # earlier tests' garbage would read as a change
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    fc.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            diags = g.check()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert diags == []
    assert torch.cuda.memory_allocated() == alloc
    assert not any(fc.launch_counts().values())
    assert [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA] == []


@pytest.mark.cuda
def test_cuda_refused_graph_allocates_nothing(cuda_device):
    import windflow_tpu_torch as wt
    g = wt.PipeGraph("two_faults", config=wt.Config(device="cuda"))
    for fn, kind in ((lambda t: {"v0": torch.cat([t["v0"], t["v0"]])},
                      wt.MapGPU_Builder),
                     (lambda t: t["v0"], wt.FilterGPU_Builder)):
        g.add_source(wt.Source_Builder(lambda: iter([]))
                     .withOutputBatchSize(4096)
                     .withRecordSpec({"key": np.int32(0),
                                      "v0": np.float32(0.0)}).build()) \
            .add(kind(fn).build()).add_sink(
            wt.Sink_Builder(lambda r: None).build())
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    with pytest.raises(wt.PreflightError) as ei:
        g.start()
    assert sorted(d.code for d in ei.value.diagnostics) == ["WF101",
                                                            "WF102"]
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == alloc
    assert g._all_replicas == []


@pytest.mark.cuda
def test_cuda_preflight_on_equals_off(cuda_device):
    got = {}
    for mode in ("error", "off"):
        cols = []
        g = _an_graph(cuda_device,
                      lambda c: cols.append(c) if c is not None else None,
                      preflight=mode)
        fc.reset_launch_counts()
        g.run()
        torch.cuda.synchronize()
        recs = sorted(zip(*(np.concatenate([np.asarray(c.cols[n])
                                            for c in cols]).tolist()
                            for n in ("key", "wid", "value"))))
        got[mode] = (recs, fc.launch_counts())
    assert got["error"] == got["off"] and got["error"][0]
    assert got["error"][1]["grouping_rank_hist"] > 0


@pytest.mark.cuda
def test_cuda_megastep_capture_failure_raises(cuda_device):
    """A tail step that reads the device on the host runs per batch but
    cannot be captured: the first group raises ``WindFlowError`` naming
    the step, never falling back to the per-batch path.  (Last in this
    file: a failed capture may leave the thread's stream state behind.)"""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.basic import WindFlowError as WFE

    def lift(t):
        # a host read of the batch: legal eagerly, illegal while capturing
        return t["v"] + 0.0 * float(t["v"].sum().item())
    blob = _ms_blob()
    step = MS_CAP * 24

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]

    def graph(preflight):
        g = wt.PipeGraph("ms_fail", time_policy=wt.TimePolicy.EVENT,
                         config=wt.Config(device="cuda", megastep_sweeps=4,
                                          key_compaction=False,
                                          punctuation_interval_usec=10 ** 12,
                                          preflight=preflight))
        g.add_source(wt.FrameSource(chunks, nv=1, fields=["v"],
                                    output_batch_size=MS_CAP)) \
            .add(wt.Ffat_WindowsGPU_Builder(lift, lambda a, b: a + b)
                 .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
                 .withMaxKeys(MS_KEYS).withName("w").build()) \
            .add_sink(wt.Sink_Builder(lambda r: None).build())
        return g
    # preflight names the host read before any capture (WF801) ...
    with pytest.raises(wt.PreflightError, match="WF801"):
        graph("error").run()
    # ... and with it off, the capture itself refuses the step
    with pytest.raises(WFE, match="capturing the ffat_cb step of 'w'"):
        graph("off").run()


# ---------------------------------------------------------------------------
# the observability planes on the card
# ---------------------------------------------------------------------------

class _Collect:
    """A stand-in emitter that keeps what a replica emits."""

    def __init__(self):
        self.out = []

    def emit_device_batch(self, b):
        self.out.append(b)


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_untraced_cb_replica_step_makes_no_host_read(cuda_device,
                                                          sum_combiner):
    """The CB replica's whole batch path with the recorder bound (its
    ring, the step registry's count): an untraced batch makes no
    synchronising call."""
    op = _cb_op(sum_combiner)
    rep = op.replicas[0]
    assert rep.ring is not None
    rep.emitter = _Collect()
    out = _no_host_read(rep.process_device_batch, _cb_batches(cuda_device, 3))
    assert out is None and len(rep.emitter.out) == 3
    assert op.watch.dispatches == 3 and rep.ring.n == 0


@pytest.mark.cuda
def test_cuda_sketched_device_keyby_split_makes_no_host_read(cuda_device):
    """The device keyby split with the shard sketch's update inside it:
    no synchronising call, and the sketch's shard counts equal the host's
    splitmix64 placement."""
    from windflow_tpu_torch.monitoring.shard_ledger import ShardSketch
    from windflow_tpu_torch.parallel import emitters as te
    em = te.DeviceKeyByEmitter([(None, 0)] * 4, lambda t: t["key"])
    sk = ShardSketch(4)
    em.attach_shard_sketch(sk)
    batches = _cb_batches(cuda_device, 3)
    _no_host_read(em.split, batches)
    k = np.concatenate([b.payload["key"].cpu().numpy() for b in batches])
    want = np.bincount((te.splitmix64_np(k) % np.uint64(4)).astype(np.int64),
                       minlength=4)
    s = sk.summary()
    assert s["tuples"] == want.tolist() and s["total_tuples"] == k.size


@pytest.mark.cuda
def test_cuda_traced_batch_makes_exactly_its_one_wait(cuda_device,
                                                      monkeypatch):
    """At ``trace_device_sync_every=1`` a traced batch waits once for its
    step's device work (the sampled ``device_done``), and nothing else of
    its path synchronises."""
    from windflow_tpu_torch.basic import current_time_usecs
    from windflow_tpu_torch.ops import gpu as tg
    op = _cb_op(False)
    rep = op.replicas[0]
    rep.config.trace_device_sync_every = 1
    rep.emitter = _Collect()
    waits = []
    real = tg.wait_for_device

    def counted(t):
        waits.append(t.device)
        torch.cuda.set_sync_debug_mode(0)
        try:
            real(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    monkeypatch.setattr(tg, "wait_for_device", counted)
    batches = _cb_batches(cuda_device, 3)
    batches[2].trace = (7, current_time_usecs())
    _no_host_read(rep.process_device_batch, batches)
    assert len(waits) == 1 and waits[0].type == "cuda"
    stages = [e["stage"] for e in rep.ring.events()]
    assert stages == ["dispatched", "device_done"]
    assert rep.emitter.out[-1].trace == batches[2].trace


@pytest.mark.cuda
def test_cuda_megastep_with_recorder_replays_the_same_graph(cuda_device):
    """A K = 8 CB megastep with the recorder tracing every other batch
    (and waiting on each traced group) equals the recorder-off run:
    records, kernel launches a group, and one ``cudaGraphLaunch`` a
    megastep; every trace that reached the sink has ordered stamps."""
    from torch.profiler import ProfilerActivity, profile
    off, soff, _ = _ms_run("cb", 8, flight_recorder=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on, son, g = _ms_run("cb", 8, trace_sample_every=2,
                             trace_device_sync_every=1)
    e_on, e_off = son["edges"][0], soff["edges"][0]
    assert on == off
    assert e_on["megasteps"] == e_off["megasteps"] >= 1
    assert e_on["kernel_launches_per_group"] == \
        e_off["kernel_launches_per_group"]
    launches = sum(1 for ev in prof.events() if ev.name == "cudaGraphLaunch")
    assert launches == e_on["megasteps"]
    by = {}
    for ev in g._recorder.events():
        by.setdefault(ev["trace"], {}).setdefault(ev["stage"], ev)
    grouped = [t for t in by.values()
               if t.get("dispatched", {}).get("shared_k") == 8]
    assert grouped and all("device_done" in t for t in grouped)
    for t in by.values():
        seq = [t[s]["t_usec"] for s in ("staged", "dispatched",
                                        "device_done", "sunk") if s in t]
        assert seq == sorted(seq)
    assert g.stats()["Device"]["jit"]["w"]["compiles"] >= 1


@pytest.mark.cuda
def test_cuda_device_section_reports_allocated_bytes(cuda_device):
    _, _, g = _ms_run("dense", 1)
    dev = g.stats()["Device"]
    assert "error" not in dev
    mem = dev["memory"]
    assert [m["platform"] for m in mem] == ["cuda"]
    assert mem[0]["stats"]["bytes_in_use"] > 0
    assert mem[0]["stats"]["peak_bytes_in_use"] >= \
        mem[0]["stats"]["bytes_in_use"]
    assert dev["live_buffers"]["bytes"] > 0
    assert dev["staging"]["staged_device_bytes_total"] > 0


@pytest.mark.cuda
def test_cuda_profile_capture_holds_the_traced_annotation(cuda_device,
                                                          tmp_path):
    import json
    import os

    def tap(g):
        d = g.profile(duration_ms=60_000, log_dir=str(tmp_path / "prof"))
        tap.dir = d
    _ms_run("cb", 1, tap=tap, trace_sample_every=1)
    with open(os.path.join(tap.dir, "ms_cuda_profile.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("op:w trace:") for n in names)


# ---------------------------------------------------------------------------
# the observability plane, part two, on the card
# ---------------------------------------------------------------------------

def _planes_graph(kind, **cfg):
    """(graph, operator) with every plane on by default (``cfg`` overrides
    Config fields): the CB window of ``_cb_op``, the TB window of
    ``_tb_graph`` or the compacted reduce of ``_compacted_reduce_op``."""
    import windflow_tpu_torch as wt
    if kind == "tb":
        g, op = _tb_graph(_tb_data(1), "auto", lambda r: None)
        for k, v in cfg.items():
            setattr(g.config, k, v)
    else:
        if kind == "cb":
            op = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                             lambda a, b: a + b)
                  .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
                  .withMaxKeys(CB_K).build())
        else:
            op = (wt.ReduceGPU_Builder(
                lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                              "v0": torch.maximum(a["v0"], b["v0"])})
                .withKeyBy(lambda t: t["key"]).withMonoidCombiner("max")
                .build())
        g = wt.PipeGraph(f"planes_{kind}", config=wt.Config(device="cuda",
                                                            **cfg))
        g.add_source(wt.Source_Builder(lambda: iter(()))
                     .withOutputBatchSize(CB_CAP).build()) \
            .add(op).add_sink(wt.Sink_Builder(lambda t: None).build())
    g._build()
    if kind == "reduce":
        op._compactor.observe(np.arange(CB_K) * 1000 + 7)
    return g, op


def _relaxed(fn, calls):
    """``fn`` counted into ``calls`` and run outside the sync check."""
    def call(*a, **k):
        calls.append(fn.__name__)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cb", "tb"])
def test_cuda_every_plane_on_makes_no_host_read_but_the_waited_one(
        cuda_device, monkeypatch, kind):
    """A window replica's traced, waited batch and a cadence tick with
    the recorder, latency ledger, tenant ledger, roofline, health, sweep
    and shard planes all on, under ``set_sync_debug_mode("error")``: the
    only host reads are the recorder's wait and the freshness gauge's
    read of that batch's fired lanes."""
    from windflow_tpu_torch.basic import current_time_usecs
    from windflow_tpu_torch.monitoring import latency_ledger as tll
    from windflow_tpu_torch.ops import gpu as tg
    g, op = _planes_graph(kind)
    assert g._latency is not None and g._tenant is not None \
        and g._roofline is not None and g._health is not None
    rep = op.replicas[0]
    assert rep.latency is g._latency
    rep.config.trace_device_sync_every = 1
    rep.emitter = _Collect()
    calls = []
    monkeypatch.setattr(tg, "wait_for_device",
                        _relaxed(tg.wait_for_device, calls))
    monkeypatch.setattr(tll, "_host", _relaxed(tll._host, calls))
    batches = _cb_batches(cuda_device, 3) if kind == "cb" \
        else _tb_batches(cuda_device)
    batches[2].trace = (7, current_time_usecs())

    def step(b):
        rep.process_device_batch(b)
        g.health_tick()
    _no_host_read(step, batches)
    assert calls[0] == "wait_for_device"
    assert calls[1:] in (["_host"], ["_host", "_host"])
    if len(calls) == 3:
        assert g._latency.per_op[op.name].freshness.count == 1


@pytest.mark.cuda
def test_cuda_compacted_reduce_planes_add_no_host_read(cuda_device,
                                                       monkeypatch):
    """The compacted reduce's traced batch and a cadence tick with every
    plane on synchronise exactly as often as with every plane off (its
    own miss-count read), the recorder's wait aside."""
    import warnings

    from windflow_tpu_torch.basic import current_time_usecs
    from windflow_tpu_torch.ops import gpu as tg
    off = dict(flight_recorder=False, health_watchdog=False,
               sweep_ledger=False, shard_ledger=False, latency_ledger=False,
               tenant_ledger=False, roofline_plane=False)
    waits = []
    monkeypatch.setattr(tg, "wait_for_device",
                        _relaxed(tg.wait_for_device, waits))
    syncs = {}
    for planes in ("on", "off"):
        g, op = _planes_graph("reduce", **({} if planes == "on" else off))
        rep = op.replicas[0]
        rep.config.trace_device_sync_every = 1
        rep.emitter = _Collect()
        batches = _cb_batches(cuda_device, 3)
        for b in batches:
            b.payload["key"] = b.payload["key"] * 1000 + 7
        batches[2].trace = (9, current_time_usecs())
        rep.process_device_batch(batches[0])
        rep.process_device_batch(batches[1])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rep.process_device_batch(batches[2])
                g.health_tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs[planes] = [str(w.message) for w in rec
                         if "synchroniz" in str(w.message)]
    assert len(syncs["on"]) == len(syncs["off"]), syncs
    assert waits == ["wait_for_device"]


@pytest.mark.cuda
def test_cuda_monitor_samples_through_a_k8_capture(cuda_device,
                                                   monkeypatch):
    """K = 8 with the monitoring thread ticking every 50 ms (no dashboard
    listening): every tick takes the capture lock, the capture succeeds,
    groups replay and the records equal K = 1's."""
    import socket

    from windflow_tpu_torch.monitoring import monitor
    monkeypatch.setattr(monitor, "SAMPLE_INTERVAL_SEC", 0.0)
    ticks = []
    real_tick = monitor.MonitoringThread._tick

    def tick(self):
        ticks.append(1)
        return real_tick(self)
    monkeypatch.setattr(monitor.MonitoringThread, "_tick", tick)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    base, _, _ = _ms_run("cb", 1)
    seen = {}

    def tap(g):
        seen["monitor"] = g._monitor
    got, sec, g = _ms_run("cb", 8, tap=tap, tracing_enabled=True,
                          dashboard_host="127.0.0.1", dashboard_port=dead,
                          trace_sample_every=1)
    e = sec["edges"][0]
    assert got == base
    assert e["captures"] >= 1 and e["megasteps"] >= 1
    assert seen["monitor"] is not None and seen["monitor"].samples_taken >= 1
    assert ticks and g._monitor is None


@pytest.mark.cuda
def test_cuda_resident_walk_counts_views_once(cuda_device):
    """The tenant ledger's resident walk: a storage reached through
    views and aliases counts once, and a K = 8 graph's resident bytes are
    within the allocator's."""
    import types

    from windflow_tpu_torch.monitoring.tenant_ledger import \
        _resident_state_bytes
    base = torch.zeros(1 << 20, dtype=torch.float32, device=cuda_device)
    a = types.SimpleNamespace(name="a", t=base, v=base[100:200],
                              nested={"w": [base.view(1024, 1024)]})
    b = types.SimpleNamespace(name="b", same=base, host=torch.zeros(10))
    per = {}
    assert _resident_state_bytes([a, b], cuda_device, per) == 4 << 20
    assert per == {"a": 4 << 20, "b": 0}
    torch.cuda.synchronize()
    assert (4 << 20) <= torch.cuda.memory_allocated()
    _, sec, g = _ms_run("cb", 8)
    assert sec["edges"][0]["megasteps"] >= 1
    row = g.stats()["Tenant"]["graph"]
    torch.cuda.synchronize()
    assert 0 < row["resident_state_bytes"] <= torch.cuda.memory_allocated()


# ---------------------------------------------------------------------------
# the apps and the host windows
# ---------------------------------------------------------------------------

def _app_rows(app, device, records, **kw):
    import windflow_tpu_torch as wt
    rows = app.run(records, config=wt.Config(device=device), **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return rows


@pytest.mark.cuda
def test_cuda_ffat_analytics_equals_its_cpu_run(cuda_device):
    from windflow_tpu_torch.models import ffat_analytics
    rng = np.random.default_rng(91)
    records = [{"k": int(k), "v": float(v)} for k, v in
               zip(rng.integers(0, 8, 6000), rng.integers(-50, 51, 6000))]
    kw = dict(win_len=64, slide=16, max_keys=8, batch=512)
    fc.reset_launch_counts()
    got = _app_rows(ffat_analytics, "cuda", records, **kw)
    launches = fc.launch_counts()
    key = lambda r: (r["key"], r["wid"])    # noqa: E731
    want = _app_rows(ffat_analytics, "cpu", records, **kw)
    assert got and sorted(got, key=key) == sorted(want, key=key)
    assert launches["grouping_rank_hist"] > 0


@pytest.mark.cuda
def test_cuda_market_ticker_equals_its_cpu_run(cuda_device):
    from windflow_tpu_torch.models import market_ticker
    rng = np.random.default_rng(92)
    # Python-float prices, the app's documented input: its lift folds
    # them in float32, the fold kernel's type
    ticks = [{"sym": int(s), "price": float(p)} for s, p in
             zip(rng.integers(0, 6, 5000), rng.integers(10, 100, 5000))]
    kw = dict(win_len=32, slide=8, max_symbols=6, batch=512)
    fc.reset_launch_counts()
    got = _app_rows(market_ticker, "cuda", ticks, **kw)
    launches = fc.launch_counts()
    key = lambda r: (r["sym"], r["wid"])    # noqa: E731
    want = _app_rows(market_ticker, "cpu", ticks, **kw)
    assert got and sorted(got, key=key) == sorted(want, key=key)
    assert launches["grouping_rank_hist"] > 0
    assert launches["sliding_fold"] > 0


def _host_tb_behind_megastep(k, device="cuda"):
    """FrameSource → the dense associative stateful tail (a megastep
    edge) → ``Keyed_Windows`` TB on the host → Sink.  Returns (records,
    whether the first record reached the sink before the window's end of
    stream, the Megastep section)."""
    import windflow_tpu_torch as wt
    out, early = [], []
    blob = _ms_blob()
    step = MS_CAP * 24 * 3 // 2

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    src = wt.FrameSource(chunks, nv=1, fields=["v"],
                         output_batch_size=MS_CAP,
                         record_spec={"key": np.int32(0),
                                      "v": np.float32(0.0)})
    win = (wt.Keyed_Windows_Builder(lambda items: sum(t["v"] for t in items))
           .withTBWindows(40_000, 10_000).withKeyBy(lambda t: t["key"])
           .withName("host_tb").build())

    def sink(r):
        if r is None:
            return
        if not out:
            early.append(not win.replicas[0]._eos_channels)
        out.append((r.key, r.wid, r.value))
    g = wt.PipeGraph("ms_host_tb", time_policy=wt.TimePolicy.EVENT,
                     config=wt.Config(device=device, megastep_sweeps=k,
                                      key_compaction=False,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(src).add(_ms_tail("assoc")).add(win) \
        .add_sink(wt.Sink_Builder(sink).build())
    g.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return sorted(out), early == [True], g.stats()["Megastep"]


@pytest.mark.cuda
def test_cuda_host_tb_window_behind_k8_megastep_fires_before_eos(
        cuda_device):
    got, early, sec = _host_tb_behind_megastep(8)
    assert got and early
    assert sec["edges"] and sec["edges"][0]["megasteps"] >= 1
    base, early1, _ = _host_tb_behind_megastep(1)
    assert got == base and early1
    cpu, _, _ = _host_tb_behind_megastep(8, device="cpu")
    assert cpu == base


# ---------------------------------------------------------------------------
# the serving plane and the native host runtime on the card
# ---------------------------------------------------------------------------

#: 24 keys, 4,096 tuples a batch 10 µs apart, 4 ms windows by 1 ms, a
#: fixed 32-pane ring, three replicas (one ring each)
SV_K, SV_CAP, SV_NP = 24, 4096, 32


@pytest.mark.cuda
def test_cuda_native_library_is_available(cuda_device):
    from windflow_tpu_torch import native
    assert native.is_available(), native.build_error()
    keys = np.arange(-50, 50, dtype=np.int64)
    native.reset_call_counts()
    dests, counts = native.keyby_partition(keys, 3)
    assert native.call_counts() == {"keyby_partition": 1}
    assert counts.sum() == len(keys)


def _sv_graph(check_sweeps=10 ** 9):
    import windflow_tpu_torch as wt
    items = _tb_data(6)
    for t in items:
        t["key"] = np.int32(t["key"] * 3 % SV_K)
    win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
           .withTBWindows(4_000, 1_000).withKeyBy(lambda t: t["key"])
           .withMaxKeys(SV_K).withPaneCapacity(SV_NP).withParallelism(3)
           .withName("win").build())
    g = wt.PipeGraph("sv_cuda", wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT,
                     config=wt.Config(device="cuda", reshard_executor=True,
                                      reshard_check_sweeps=check_sweeps,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(wt.Source_Builder(lambda: iter(items))
                 .withTimestampExtractor(lambda t: t["ts"])
                 .withOutputBatchSize(SV_CAP).build()) \
        .add(win).add_sink(wt.Sink_Builder(lambda r: None).build())
    return g, win


@pytest.mark.cuda
def test_cuda_tb_row_move_replays_under_a_k8_capture(cuda_device):
    """``chip_smoke.moved_row_replay_check`` at a small size: the row
    moved in place into the captured body's static carry is what the
    replay reads (output and final carry equal the eager run's), and a
    rebinding move of the same row, as the JAX package's functional
    update, leaves the replay on the old storage, so it would differ."""
    import chip_smoke
    from windflow_tpu_torch.utils.tree import tree_map
    g, win = _sv_graph()
    g.run()
    x = g._reshard
    ok, moved, per = chip_smoke.moved_row_replay_check(
        win, x, 3, cuda_device, SV_CAP)
    assert ok and moved == 1 and per > 0

    # the counterfactual: a move that rebinds the carry's leaves
    def rebinding(op, moves):
        for m in moves:
            row = m["key"]
            src, dst = op._states[m["from_shard"]], op._states[m["to_shard"]]
            for name in ("cells", "cell_valid", "horizon"):
                def put(d, s_):
                    d = d.clone()
                    d[row] = s_[row]
                    return d
                dst[name] = tree_map(put, dst[name], src[name])
        return len(moves)
    x._move_ffat_rows = rebinding
    bad, _, _ = chip_smoke.moved_row_replay_check(win, x, 3, cuda_device,
                                                  SV_CAP)
    assert not bad


@pytest.mark.cuda
def test_cuda_steps_between_executor_ticks_make_no_host_read(cuda_device):
    """Three keyed TB replicas stepping, with the executor's per-sweep
    hook between them, under ``set_sync_debug_mode("error")``; then an
    in-place ring-row move under the same mode, only its ring-clock read
    relaxed (once), and more steps."""
    from windflow_tpu_torch.batch import HostBatch, host_to_device
    g, win = _sv_graph()
    g._build()
    x = g._reshard
    items = _tb_data(6)
    batches = []
    for i in range(6):
        chunk = items[i * SV_CAP:(i + 1) * SV_CAP]
        for t in chunk:
            t["key"] = np.int32(t["key"] * 3 % SV_K)
        tss = [t["ts"] for t in chunk]
        batches.append(host_to_device(HostBatch(chunk, tss, watermark=tss[0]),
                                      SV_CAP, cuda_device, frontier=tss[-1]))

    def sweep(b):
        for ridx in range(3):
            win._step(b, ridx)
        x.on_sweep()
    sweep(batches[0])
    sweep(batches[1])
    torch.cuda.synchronize()
    calls = []
    x._ring_clocks = _relaxed(x._ring_clocks, calls)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sweep(batches[2])
        sweep(batches[3])
        moved = x._move_ffat_rows(win, [{"key": 3, "from_shard": 0,
                                         "to_shard": 1, "est_tuples": 1}])
        sweep(batches[4])
        sweep(batches[5])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert moved == 1 and calls == ["_ring_clocks"]
    assert x.ticks == 0 and win._overflow_steps < 31


# ---------------------------------------------------------------------------
# the host worker pool and the capture audit on the card
# ---------------------------------------------------------------------------

def _pool_k8_graph(threads, out, device="cuda"):
    """FrameSource → count windows (a K = 8 megastep edge) → host Map
    (on the egress edge: the driver thread) → host Map → Sink (a
    host-only chain: pooled)."""
    import windflow_tpu_torch as wt
    blob = _ms_blob()
    step = MS_CAP * 24 * 3 // 2

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    src = wt.FrameSource(chunks, nv=1, fields=["v"],
                         output_batch_size=MS_CAP,
                         record_spec={"key": np.int32(0),
                                      "v": np.float32(0.0)})
    g = wt.PipeGraph("pool_k8", time_policy=wt.TimePolicy.EVENT,
                     config=wt.Config(
                         device=device, megastep_sweeps=8,
                         host_worker_threads=threads, key_compaction=False,
                         wire_compression=False,
                         punctuation_interval_usec=10 ** 12))
    g.add_source(src).add(_ms_tail("cb")) \
        .add(wt.Map_Builder(lambda r: (int(r["key"]), int(r["wid"]),
                                       float(r["value"])))
             .withName("egress_map").build()) \
        .add(wt.Map_Builder(lambda r: r).withName("chain_map").build()) \
        .add_sink(wt.Sink_Builder(lambda r: out.append(r) if r is not None
                                  else None).withName("chain_sink").build())
    return g


@pytest.mark.cuda
def test_cuda_k8_capture_with_pool_threads_and_a_host_chain(cuda_device):
    """A K = 8 capture on the driver thread while 4 pool threads drain
    the host-only chain behind the egress: the group is captured and
    replayed, the egress Map stays on the driver thread, the chain is
    pooled, and the records equal the pool-off run's, in order."""
    got = {}
    for threads in (0, 4):
        out = []
        g = _pool_k8_graph(threads, out)
        g.run()
        torch.cuda.synchronize()
        edge = g.stats()["Megastep"]["edges"][0]
        assert edge["captures"] >= 1 and edge["megasteps"] >= 1
        if threads:
            assert {r.op.name for r in g._pool_replicas} == {
                "chain_map", "chain_sink"}
            assert "egress_map" in {r.op.name for r in g._main_replicas}
        got[threads] = out
    assert got[4] and got[4] == got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_audit_first_step_recording_makes_no_host_read(cuda_device,
                                                            sum_combiner):
    """The capture audit records the CB replica's first step under
    ``set_sync_debug_mode("error")``: the recording makes no
    synchronising call of its own, leaves the mode as it found it, and
    its facts show the kernel launches and no finding."""
    from windflow_tpu_torch.analysis import ir_audit
    op = _cb_op(sum_combiner)
    rep = op.replicas[0]
    rep.emitter = _Collect()
    batches = _cb_batches(cuda_device, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep.process_device_batch(batches[0])
        assert torch.cuda.get_sync_debug_mode() == 2
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    (facts,) = op._audit_programs[op.name].values()
    assert facts["backend"] == "cuda" and facts["kind"] == "step"
    assert facts["kernel_launches"] >= (2 if sum_combiner else 1)
    assert ir_audit.program_findings(op.name, facts) == []
    rep.process_device_batch(batches[1])      # the shadow is gone
    assert len(op._audit_programs[op.name]) == 1


def _audit_cb_graph(out, sum_combiner=False, **cfg):
    import windflow_tpu_torch as wt
    blob = _ms_blob()
    src = wt.FrameSource(lambda: iter([blob]), nv=1, fields=["v"],
                         output_batch_size=MS_CAP,
                         record_spec={"key": np.int32(0),
                                      "v": np.float32(0.0)})
    g = wt.PipeGraph("audit_cb", config=wt.Config(
        device="cuda", megastep_sweeps=1,
        punctuation_interval_usec=10 ** 12, **cfg))
    tail = _ms_tail("cb")
    if sum_combiner:
        tail = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"],
                                           lambda a, b: a + b)
                .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
                .withMaxKeys(MS_KEYS).withSumCombiner().withName("w")
                .build())
    g.add_source(src).add(tail).add_sink(
        wt.Sink_Builder(lambda r: out.append(
            (int(r["key"]), int(r["wid"]), float(r["value"])))
            if r is not None else None).build())
    return g


@pytest.mark.cuda
def test_cuda_audit_wf907_when_the_grouping_wrapper_runs_plain(
        cuda_device, monkeypatch):
    """Within its gate the grouping step launches the kernel and audits
    clean; with the wrapper swapped for its plain version the same step
    launches nothing, is WF907, and its records are unchanged."""
    from windflow_tpu_torch.windows import ffat_kernels
    base = []
    g = _audit_cb_graph(base)
    g.run()
    sec = g.stats()["IR_audit"]
    assert sec["findings"] == [] and sec["programs"][0][
        "kernel_launches"] >= 1
    monkeypatch.setattr(fc, "order_hist",
                        lambda ids, nb: ffat_kernels.order_and_hist(ids, nb))
    out = []
    g = _audit_cb_graph(out)
    fc.reset_launch_counts()
    g.run()
    assert fc.launch_counts()["grouping_rank_hist"] == 0
    assert [f["code"] for f in g.stats()["IR_audit"]["findings"]] == [
        "WF907"]
    assert sorted(out) == sorted(base)


@pytest.mark.cuda
def test_cuda_audit_wf907_per_kernel_on_the_sum_step(cuda_device,
                                                      monkeypatch):
    """The sum-combiner step with only the fold wrapper swapped for its
    plain version: the grouping kernel still launches, so the step's
    total launches are not 0, and the audit is WF907 for the fold."""
    from windflow_tpu_torch.utils.tree import tree_map
    base = []
    _audit_cb_graph(base, sum_combiner=True).run()
    monkeypatch.setattr(fc, "sliding_fold", lambda v, m, R, mo: tree_map(
        lambda leaf: fc.fold_leaf_plain(leaf, m, R, mo), v))
    out = []
    g = _audit_cb_graph(out, sum_combiner=True)
    fc.reset_launch_counts()
    g.run()
    counts = fc.launch_counts()
    assert counts["sliding_fold"] == 0 and counts["grouping_rank_hist"] > 0
    (f,) = g.stats()["IR_audit"]["findings"]
    assert f["code"] == "WF907" and "sliding_fold" in f["message"]
    assert sorted(out) == sorted(base)


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_ffat_grouping_argsort_keeps_the_kernel(cuda_device,
                                                     sum_combiner):
    """``Config.ffat_grouping="argsort"`` on a CUDA graph with the
    kernels on: the grouping kernel keeps the job, the audit is clean,
    and the records equal the default grouping's."""
    base = []
    _audit_cb_graph(base, sum_combiner).run()
    out = []
    g = _audit_cb_graph(out, sum_combiner, ffat_grouping="argsort")
    fc.reset_launch_counts()
    g.run()
    assert fc.launch_counts()["grouping_rank_hist"] > 0
    assert g.stats()["IR_audit"]["findings"] == []
    assert sorted(out) == sorted(base)


@pytest.mark.cuda
def test_cuda_audit_wf906_on_an_item_read(cuda_device):
    """A MapGPU whose function reads ``.item()`` on the card: its first
    step is recorded with the host read and the sync, WF906."""
    import windflow_tpu_torch as wt
    blob = _ms_blob()
    src = wt.FrameSource(lambda: iter([blob]), nv=1, fields=["v"],
                         output_batch_size=MS_CAP,
                         record_spec={"key": np.int32(0),
                                      "v": np.float32(0.0)})
    g = wt.PipeGraph("audit_item", config=wt.Config(
        device="cuda", preflight="off"))
    g.add_source(src).add(wt.MapGPU_Builder(
        lambda t: {"key": t["key"], "v": t["v"] * float(t["v"].sum().item())})
        .withName("item_map").build()).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    g.run()
    (f,) = g.stats()["IR_audit"]["findings"]
    assert f["code"] == "WF906" and "_local_scalar_dense" in f["message"]
    assert "cuda sync" in f["message"]


# ---------------------------------------------------------------------------
# the mesh (parallel/mesh.py): 4 logical positions on one card
# ---------------------------------------------------------------------------

def _card_mesh(data=1):
    from windflow_tpu_torch.parallel import mesh as M
    return M.make_mesh(4, data=data, devices=["cuda:0"] * 4)


def _mesh_cb_op(sum_combiner, data):
    import windflow_tpu_torch as wt
    wb = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
          .withMaxKeys(CB_K))
    if sum_combiner:
        wb = wb.withSumCombiner()
    op = wb.build()
    g = wt.PipeGraph("cb_mesh_cuda", config=wt.Config(
        device="cuda", mesh=_card_mesh(data)))
    g.add_source(wt.Source_Builder(lambda: iter(())).withOutputBatchSize(
        CB_CAP).build()).add(
        wt.MapGPU_Builder(lambda t: t).build()).add(op).add_sink(
        wt.Sink_Builder(lambda t: None).build())
    g._build()
    return op


@pytest.mark.cuda
@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_mesh_cb_step_launches_per_key_shard_and_makes_no_host_read(
        cuda_device, sum_combiner, data):
    """The sharded count-window step on 4 positions of the card: one
    grouping launch (and with ``withSumCombiner`` one fold launch) a
    position a step, no synchronising call, and the records of the
    single-device step."""
    op = _mesh_cb_op(sum_combiner, data)
    ref = _cb_op(sum_combiner)
    batches = _cb_batches(cuda_device, 3)
    for b in batches[:2]:
        ref._step(b)
    want = ref._step(batches[2])
    fc.reset_launch_counts()
    out = _no_host_read(op._step, batches)
    counts = fc.launch_counts()
    assert counts["grouping_rank_hist"] == 3 * 4
    assert counts["sliding_fold"] == (3 * 4 if sum_combiner else 0)

    def fired(b):
        f = b.valid.cpu().numpy()
        return sorted(zip(b.payload["key"].cpu().numpy()[f].tolist(),
                          b.payload["wid"].cpu().numpy()[f].tolist(),
                          b.payload["value"].cpu().numpy()[f].tolist()))
    assert fired(out) and fired(out) == fired(want)
    assert op._states[0].equal_across_data()


@pytest.mark.cuda
def test_cuda_mesh_tb_step_launches_per_key_shard_and_makes_no_host_read(
        cuda_device):
    """The sharded time-window step: (key, pane) ids under the grouping
    kernel's gate launch it a position a step, with no synchronising
    call away from the ring's first sizing."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.batch import HostBatch, host_to_device
    items = _tb_data(4)
    op = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withTBWindows(4_000, 1_000).withKeyBy(lambda t: t["key"])
          .withMaxKeys(TB_K).build())
    g = wt.PipeGraph("tb_mesh_cuda", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT,
                     config=wt.Config(device="cuda", mesh=_card_mesh()))
    g.add_source(wt.Source_Builder(lambda: iter(()))
                 .withTimestampExtractor(lambda t: t["ts"])
                 .withOutputBatchSize(TB_CAP).build()) \
        .add(wt.MapGPU_Builder(lambda t: t).build()).add(op) \
        .add_sink(wt.Sink_Builder(lambda r: None).build())
    g._build()
    batches = []
    for i in range(4):
        chunk = items[i * TB_CAP:(i + 1) * TB_CAP]
        tss = [t["ts"] for t in chunk]
        batches.append(host_to_device(HostBatch(chunk, tss, watermark=tss[0]),
                                      TB_CAP, cuda_device,
                                      frontier=tss[-1]))
    op._step(batches[0])        # the ring's first sizing reads the card
    fc.reset_launch_counts()
    out = _no_host_read(op._step, batches[1:])
    assert fc.launch_counts()["grouping_rank_hist"] >= 3 * 4
    assert out.valid.shape[0] > 0
    assert op._states[0].equal_across_data()


def _aligned_keys(keys, kk, dd, K):
    """``keys`` laid out as the key-aligned emitter stages them: flat
    block ``b`` belongs to key column ``b % kk``, which owns
    ``[c * K / kk, (c + 1) * K / kk)``."""
    K_local = K // kk
    col = (np.arange(len(keys)) // (len(keys) // (kk * dd))) % kk
    return (col * K_local + keys % K_local).astype(np.int32)


def _mesh_batch(cuda_device, data, cap=8192, K=64):
    """``(mesh, payload, aligned payload, ts, valid)`` on 4 positions."""
    mesh = _card_mesh(data)
    kk, dd = mesh.shape["key"], mesh.shape["data"]
    rng = np.random.default_rng(3)
    keys = rng.integers(0, K, cap).astype(np.int32)
    vals = torch.as_tensor(rng.integers(-50, 50, cap).astype(np.float32),
                           device=cuda_device)
    payload = {"key": torch.as_tensor(keys, device=cuda_device), "v": vals}
    aligned = {"key": torch.as_tensor(_aligned_keys(keys, kk, dd, K),
                                      device=cuda_device), "v": vals}
    ts = torch.arange(cap, dtype=torch.int64, device=cuda_device)
    valid = torch.ones(cap, dtype=torch.bool, device=cuda_device)
    return mesh, payload, aligned, ts, valid


def _one_step_no_host_read(step):
    """A warm call, then one under ``set_sync_debug_mode("error")``."""
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("route", ["sum", "max", "min", "generic",
                                   "aligned", "all_to_all"])
def test_cuda_mesh_reduce_steps_make_no_host_read(cuda_device, route, data):
    """The sharded dense reduce (psum, pmax, pmin, the generic fold, the
    aligned ingest) and the arbitrary-key (all_to_all) reduce make no
    synchronising call, and every key has a row."""
    from windflow_tpu_torch.parallel import mesh as M
    mesh, payload, aligned, ts, valid = _mesh_batch(cuda_device, data)
    op = {"sum": torch.add, "min": torch.minimum}.get(route, torch.maximum)
    comb = lambda a, b: {"key": op(a["key"], b["key"]),  # noqa: E731
                         "v": op(a["v"], b["v"])}
    key_fn = lambda t: t["key"]  # noqa: E731
    cap = valid.shape[0]
    if route == "all_to_all":
        step = M.make_sharded_reduce_arbitrary(mesh, cap, comb, key_fn)
    else:
        step = M.make_sharded_reduce_step(
            mesh, cap, 64, comb, key_fn,
            monoid=None if route in ("generic", "aligned") else route,
            ingest="aligned" if route == "aligned" else "data",
            kernels=True)
    pl = aligned if route == "aligned" else payload
    out = _one_step_no_host_read(lambda: step(pl, ts, valid))
    assert int(out[2].sum()) == 64


@pytest.mark.cuda
@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("ingest", ["data", "aligned"])
def test_cuda_mesh_stateful_step_makes_no_host_read(cuda_device, ingest,
                                                    data):
    """The sharded stateful step over dense key-sharded state (the
    associative body) under the data ingest (the psum merge across key
    shards) and the aligned one: no synchronising call, and the per-key
    running counts of the single-device body."""
    from windflow_tpu_torch.ops.gpu_stateful import _assoc_body
    from windflow_tpu_torch.parallel import mesh as M
    mesh, payload, aligned, ts, valid = _mesh_batch(cuda_device, data)
    pl = aligned if ingest == "aligned" else payload
    cap, S = valid.shape[0], 64
    lift = lambda t: {"n": torch.ones_like(t["key"])}  # noqa: E731
    comb = lambda a, b: {"n": a["n"] + b["n"]}  # noqa: E731
    project = lambda t, s: {"key": t["key"], "n": s["n"]}  # noqa: E731
    step = M.make_sharded_stateful_step(
        mesh, cap, S,
        lambda c, s: _assoc_body(lift, comb, project, c, s, False),
        lambda t: t["key"], True, False, ingest=ingest)
    state = [M.shard_state({"n": torch.zeros(S, dtype=torch.int32)}, mesh)]

    def run():
        state[0], out, ok = step(state[0], pl, valid)
        return out, ok
    out, ok = _one_step_no_host_read(run)
    assert bool(ok.all())
    keys = out["key"].cpu().numpy()
    n = out["n"].cpu().numpy()
    # the second pass over the batch: a key's i-th lane (in lane order
    # within its block layout) sees the first pass's count plus i + 1
    for key in np.unique(keys):
        got = np.sort(n[keys == key])
        cnt = int((keys == key).sum())
        assert np.array_equal(got, cnt + np.arange(1, cnt + 1))
    assert state[0].equal_across_data()


@pytest.mark.cuda
@pytest.mark.parametrize("data", [1, 2])
def test_cuda_mesh_wavefront_step_makes_no_host_read(cuda_device, data):
    """The sharded stateful step over the wavefront body (a general
    running count, its device loop on every key shard) under the data
    ingest: no synchronising call, the loop launched once a position a
    step, and the per-key running counts of the single-device body."""
    from windflow_tpu_torch.ops.gpu_stateful import _wavefront_body
    from windflow_tpu_torch.parallel import mesh as M
    mesh, payload, _, _, valid = _mesh_batch(cuda_device, data)
    cap, S = valid.shape[0], 64

    def fn(t, s):
        n = s["n"] + 1
        return {"key": t["key"], "n": n}, {"n": n}
    step = M.make_sharded_stateful_step(
        mesh, cap, S,
        lambda c, s: _wavefront_body(fn, c, s, False, kernels=True),
        lambda t: t["key"], True, False, ingest="data")
    state = [M.shard_state({"n": torch.zeros(S, dtype=torch.int32)}, mesh)]

    def run():
        state[0], out, ok = step(state[0], payload, valid)
        return out, ok
    fc.reset_launch_counts()
    out, ok = _one_step_no_host_read(run)
    assert fc.launch_counts()["wavefront_loop"] == 2 * 4
    assert bool(ok.all())
    keys = out["key"].cpu().numpy()
    n = out["n"].cpu().numpy()
    for key in np.unique(keys):
        got = np.sort(n[keys == key])
        cnt = int((keys == key).sum())
        assert np.array_equal(got, cnt + np.arange(1, cnt + 1))
    assert state[0].equal_across_data()


@pytest.mark.cuda
def test_cuda_make_mesh_refuses_more_devices_than_visible(cuda_device):
    """Without ``devices=`` the mesh takes the visible cards and never
    drops to the CPU: more positions than cards is refused, with JAX's
    message; a repeated device makes the logical mesh."""
    from windflow_tpu_torch.parallel import mesh as M
    n = torch.cuda.device_count()
    with pytest.raises(M.WindFlowError, match=f"requested {n + 1} devices, "
                                            f"only {n} visible"):
        M.make_mesh(n + 1)
    mesh = M.make_mesh(4, devices=["cuda:0"] * 4)
    assert {d.type for d in mesh.devices.ravel()} == {"cuda"}


# ---------------------------------------------------------------------------
# the JAX package's lax.conds as SWITCH nodes (kernels/cond_cuda.py)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("nbodies", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_cond_select_matches_its_plain_twin(cuda_device, nbodies,
                                                 dtype):
    """The steering kernel against its plain twin for every index of an
    n-body switch and three out-of-range ones: captured as a SWITCH node
    whose body j writes j + 1, each replay runs the twin's pick (none
    out of range), and the device counters equal the twin's."""
    from windflow_tpu_torch.kernels import cond_cuda as cc
    dev = torch.device("cuda", torch.cuda.current_device())
    cc.prepare(dev)
    site = f"card test {nbodies} {dtype}"
    index = torch.zeros((), dtype=dtype, device=dev)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    bodies = [lambda j=j: out.fill_(j + 1) for j in range(nbodies)]
    g = fc.CountedGraph(torch.cuda.CUDAGraph())
    from windflow_tpu_torch.kernels import loop_cuda
    with g.capture(loop_cuda.side_capture(g.graph, dev)):
        cc.emit_switch(index, bodies, site)
    assert g.launches == {"cond_select": 1}
    cc.reset_body_counts(dev)
    plain = torch.zeros(nbodies + 1, dtype=torch.int64)
    for i in list(range(nbodies)) + [nbodies, -1, 1 << 20]:
        index.fill_(i)
        out.zero_()
        fc.reset_launch_counts()
        g.replay()
        pick = cc.cond_select_plain(torch.tensor(i, dtype=dtype), nbodies,
                                    plain)
        assert int(out) == (pick + 1 if pick < nbodies else 0)
        assert fc.launch_counts()["cond_select"] == 1
    assert cc.body_counts(dev, site, nbodies) == plain.tolist()
    # eager: the kernel counts its pick and sets no handle
    cc.cond_select(index, nbodies, site=site)
    assert cc.body_counts(dev, site, nbodies)[-1] == plain.tolist()[-1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("sum_combiner", [False, True])
def test_cuda_tb_step_folds_through_its_cached_switch_graph(cuda_device,
                                                            sum_combiner):
    """The TB step at K = 1: each fire pass's fold region replays one
    cached standalone graph (a SWITCH node of no_fold and do_fold) with
    no synchronising call after the first step; the outputs equal the
    kill switch's on every lane, and the body counters show the fold
    skipped on the ordered stream's pre-place passes."""
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.windows import ffat_kernels as tfk
    dev = torch.device("cuda", torch.cuda.current_device())
    items = _tb_data(4)
    ops = {}
    for kern in ("auto", "0"):
        g, win = _tb_graph(items, kern, lambda r: None,
                           sum_combiner=sum_combiner)
        g._build()
        ops[kern] = win
    batches = _tb_batches(cuda_device, 3)
    cc.reset_body_counts(dev)
    fc.reset_launch_counts()
    on = _no_host_read(ops["auto"]._step, batches)
    assert fc.launch_counts()["cond_select"] == 3 * 3
    counts = cc.body_counts(dev, tfk.FOLD_SITE, 2)
    assert sum(counts) == 9 and counts[0] >= 1 and counts[1] >= 1
    off = _no_host_read(ops["0"]._step, batches)
    assert fc.launch_counts()["cond_select"] == 3 * 3
    for a, b in zip(_leaves((on.payload, on.ts, on.valid)),
                    _leaves((off.payload, off.ts, off.valid))):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_tb_k8_capture_holds_the_fold_switch(cuda_device,
                                                  monkeypatch):
    """The TB tail at K = 8 over 32 batches (a warm-up, three groups, the
    rest per batch): the capture holds three SWITCH nodes a row, every
    cached group replays with no synchronising call, the records equal
    K = 1's, cond_select launches as often as at K = 1 (3 a step), and
    the device counters show passes that skipped the fold."""
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.windows import ffat_kernels as tfk
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 2 * MS_N
    fc.reset_launch_counts()
    base, _, _ = _ms_run("tb", 1, n=n)
    launches1 = fc.launch_counts()
    seen = _strict_replays(monkeypatch)
    cc.reset_body_counts(dev)
    fc.reset_launch_counts()
    got, sec, _ = _ms_run("tb", 8, n=n)
    e = sec["edges"][0]
    assert base and got == base
    assert e["megasteps"] == 3 and seen[0] == 2
    assert fc.launch_counts()["cond_select"] \
        == launches1["cond_select"] >= 3 * (n // MS_CAP)
    assert e["kernel_launches_per_group"] >= 3 * 8
    skipped, folded, none = cc.body_counts(dev, tfk.FOLD_SITE, 2)
    assert skipped > 0 and folded > 0 and none == 0


def _compacted_batches(device):
    """Four batches of the compacted reduce's step (keys admitted
    ``k * 1000 + 7``, k < CB_K): all hit, all hit, 100 misses (within the
    256-lane overflow lane), 4,000 misses (beyond it)."""
    from windflow_tpu_torch.parallel.compaction import overflow_cap
    assert 100 <= overflow_cap(CB_CAP) < 4000
    out = []
    for b, n_miss in zip(_cb_batches(device, 4, seed=91), (0, 0, 100, 4000)):
        keys = b.payload["key"] * 1000 + 7
        keys[:n_miss] = keys[:n_miss] + 1          # never admitted
        b.payload["key"] = keys
        out.append(b)
    return out


@pytest.mark.cuda
def test_cuda_compacted_reduce_branches_run_with_no_host_read(cuda_device):
    """The compacted reduce's step on the card in each branch, after a
    first step that captures its cached graph: no synchronising call, the
    body counters name no_miss, ovf_small and ovf_big in turn, the
    full-width count ``big`` moves once, and every output equals the
    kill switch's step (its host read picks the branch)."""
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.parallel import compaction as tc
    dev = torch.device("cuda", torch.cuda.current_device())
    op = _compacted_reduce_op()
    batches = _compacted_batches(cuda_device)
    plain = tc.make_compacted_reduce(CB_CAP, op._compactor.slots, "max",
                                     op.comb, op.key_extractor, False,
                                     kernels=False)
    step = op._get_compacted_step(CB_CAP)
    tables = op._compactor.tables()
    cst = tc.cstats_init(dev)
    pst = tc.cstats_init(dev)
    cc.reset_body_counts(dev)
    for i, b in enumerate(batches):
        args = (b.keys, b.payload, b.ts, b.valid, *tables)
        if i == 0:
            out = step(*args, cst)
        else:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = step(*args, cst)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        ref = plain(*args, pst)
        cst, pst = out[3], ref[3]
        for a, r in zip(_leaves(out), _leaves(ref)):
            assert torch.equal(a, r)
        assert cc.body_counts(dev, tc.BRANCH_SITE, 3) == [
            [1, 0, 0, 0], [2, 0, 0, 0], [2, 1, 0, 0], [2, 1, 1, 0]][i]
    assert int(cst["big"]) == 1


# ---------------------------------------------------------------------------
# Host spans (monitoring/recorder.py) around the megastep on the card

def _graph_nodes(graph) -> int:
    """Nodes of a captured (and kept) torch CUDA graph, by libcuda's
    ``cuGraphGetNodes``."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(n))
    assert rc == 0, f"cuGraphGetNodes returned {rc}"
    return n.value


@pytest.mark.cuda
def test_cuda_megastep_capture_has_the_same_nodes_with_spans(cuda_device,
                                                             monkeypatch,
                                                             tmp_path):
    """A K = 8 TB megastep captured with the host spans off and with them
    on (``tracing_enabled``): the same records, the same node count in
    the captured graph, the same launches a group; the spans ran around
    the capture and none entered it."""
    import inspect
    if "keep_graph" not in inspect.signature(
            torch.cuda.CUDAGraph.__new__).parameters:
        pytest.skip("this torch cannot keep a captured graph to count "
                    "its nodes (CUDAGraph(keep_graph=True))")
    base = torch.cuda.CUDAGraph

    class Kept(base):
        # pybind's __init__ makes the graph: keep_graph goes there
        def __init__(self, keep_graph=False):
            super().__init__(True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Kept)
    nodes, out = {}, {}
    for on in (False, True):
        got, sec, g = _ms_run("tb", 8, n=MS_CAP * 24, tracing_enabled=on,
                              log_dir=str(tmp_path))
        edge = g._megastep_plane.edges[0]
        assert sec["edges"][0]["megasteps"] >= 2
        assert sec["edges"][0]["captures"] == 1
        nodes[on] = _graph_nodes(edge._group.graph.graph)
        out[on] = (got, sec["edges"][0]["kernel_launches_per_group"])
        spans = g.stats()["Spans"]
        assert spans["enabled"] is on
        if on:
            assert spans["spans"]["wf:megastep.launch"]["count"] \
                == sec["edges"][0]["megasteps"]
    assert nodes[False] == nodes[True] > 0
    assert out[False] == out[True] and out[False][0]


@pytest.mark.cuda
def test_cuda_recorder_stamps_and_launch_spans_share_a_clock(cuda_device,
                                                             tmp_path):
    """In a ``profile()`` capture, each group's ``dispatched`` stamp in
    ``dump_trace()``'s events and the start of the group's
    ``wf:megastep.launch`` span (the capture's clock) differ by under
    0.1 ms: the recorder's stamps and the profiler's share one clock."""
    import json
    import os

    def tap(g):
        tap.dir = g.profile(duration_ms=60_000,
                            log_dir=str(tmp_path / "prof"))
    _, sec, g = _ms_run("tb", 8, tap=tap, n=MS_CAP * 64,
                        trace_sample_every=1)
    path = g.dump_trace(str(tmp_path / "ms_trace.json"))
    with open(path.replace("_trace.json", "_events.json")) as f:
        events = json.load(f)
    stamps = sorted({e["t_usec"] for e in events
                     if e["stage"] == "dispatched" and e["shared_k"] == 8})
    with open(os.path.join(tap.dir, "ms_cuda_profile.json")) as f:
        prof = json.load(f)
    base_us = prof.get("baseTimeNanoseconds", 0) / 1e3
    # the host's range (the device's mirror is a gpu_user_annotation)
    starts = np.array(sorted(e["ts"] + base_us for e in prof["traceEvents"]
                             if e.get("name") == "wf:megastep.launch"
                             and e.get("ph") == "X"
                             and e.get("cat") == "user_annotation"))
    megasteps = sec["edges"][0]["megasteps"]
    assert megasteps >= 4 and len(stamps) == len(starts) == megasteps
    i = np.clip(np.searchsorted(starts, stamps), 1, len(starts) - 1)
    near = np.where(np.abs(starts[i] - stamps) < np.abs(starts[i - 1]
                                                         - stamps),
                    starts[i], starts[i - 1])
    off = np.asarray(stamps) - near
    print(f"dispatched - launch span start, µs: median "
          f"{float(np.median(off)):.3f}, min {float(off.min()):.3f}, max "
          f"{float(off.max()):.3f}, over {len(off)} groups")
    assert np.all(np.abs(off) < 100.0)


# ---------------------------------------------------------------------------
# DSPBench FraudDetection's predictor (models/fraud_detection.py) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_dspbench_fraud_k8_matches_the_literal_reference(cuda_device):
    """DSPBench's windowed missProbability scorer at K = 8 on the card,
    over 20,000 transactions of 1,500 cards in batches of 1,024: the plane
    folds the wavefront tail, the alerts (stream index, card, window)
    equal the literal float64 reference's and each score lies within
    1e-6 of it (a transaction within 1e-6 of the threshold excused from
    the set), the state is
    still the operator's table with its dump row (updated in place), and
    the device counters read every lane."""
    import windflow_tpu_torch as wt
    from reference import fraud_dspbench as literal
    from windflow_tpu_torch.models import fraud_detection as fd
    from windflow_tpu_torch.ops import gpu_stateful as gst
    rng = np.random.default_rng(24)
    n, cards = 20000, 1500
    transition = rng.dirichlet(np.full(18, 12.0), size=18)
    card, state = rng.integers(0, cards, n), rng.integers(0, 18, n)
    f = np.zeros(n, np.dtype([("key", "<i8"), ("ts", "<i8"),
                              ("v", "<f8", (2,))]))
    f["key"], f["ts"], f["v"][:, 1] = card, np.arange(n), state
    blob = f.tobytes()
    got = []

    def sink(cols, ctx=None):
        if cols is not None:
            got.append((np.asarray(cols.tss), np.asarray(cols.cols["card"]),
                        np.asarray(cols.cols["score"]),
                        np.stack([np.asarray(cols.cols[f"s{i}"])
                                  for i in range(5)], 1)))
    src = wt.FrameSource(lambda: (blob[i:i + 65536]
                                  for i in range(0, len(blob), 65536)),
                         nv=2, fields=["transaction_id", "state"],
                         output_batch_size=1024)
    g = fd.build_dspbench(src, transition, sink, cards=cards,
                          config=wt.Config(device="cuda",
                                           punctuation_interval_usec=10**12,
                                           megastep_sweeps=8))
    g.run()
    st = g.stats()
    edge = st["Megastep"]["edges"][0]
    assert st["Megastep"]["refused"] == [] and edge["megasteps"] >= 1
    assert st["Stateful"]["markov_predictor"]["lanes"] == n
    op = next(o for o in g._operators if o.name == "markov_predictor")
    assert gst._dump_tables(op._state, cards) is not None
    idx, gcard, gscore, gstates = (np.concatenate(a) for a in zip(*got))
    ref = {s["index"]: s for s in literal.predict(
        zip(card.tolist(), state.tolist()), transition)}
    border = {i for i, s in ref.items() if abs(s["score"] - 0.96) <= 1e-6}
    want = {i for i, s in ref.items() if s["outlier"]} - border
    assert len(set(idx.tolist())) == len(idx)
    assert set(idx.tolist()) - border == want and len(want) > 100
    for i, c, sc, sts in zip(idx.tolist(), gcard.tolist(), gscore.tolist(),
                             gstates.tolist()):
        assert c == ref[i]["card"] and tuple(sts) == ref[i]["states"]
        assert abs(sc - ref[i]["score"]) <= 1e-6


@pytest.mark.cuda
def test_cuda_egress_reuses_one_pinned_buffer_and_owns_its_columns(
        cuda_device):
    """Columnar egress from the card lands in the thread's page-locked
    buffer, reused by the next delivery; the columns it returned before
    keep their values, on the slice route and the gather route."""
    from windflow_tpu_torch import batch as tbatch
    n = 262144

    def dev_batch(base, valid, size):
        return tbatch.DeviceBatch(
            {"a": torch.arange(n, dtype=torch.int32, device=cuda_device)
             + base},
            torch.arange(n, dtype=torch.int64, device=cuda_device) + base,
            valid.to(cuda_device), size=size)

    full = torch.ones(n, dtype=torch.bool)
    holes = torch.arange(n) % 3 == 0
    first = tbatch.device_to_columns_multi(
        [dev_batch(0, full, n), dev_batch(5, holes, None)])
    buf = tbatch._egress_host.buf
    assert buf.is_pinned()
    tbatch.device_to_columns_multi(
        [dev_batch(100, full, n), dev_batch(200, full, n)])
    assert tbatch._egress_host.buf.data_ptr() == buf.data_ptr()
    (a0, t0), (a1, t1) = first
    assert np.array_equal(a0["a"], np.arange(n)) and np.array_equal(
        t0, np.arange(n))
    want = np.flatnonzero(holes.numpy())
    assert np.array_equal(a1["a"], want + 5) and np.array_equal(t1, want + 5)
