"""DSPBench FraudDetection's predictor on the port
(``windflow_tpu_torch/models/fraud_detection.py`` ``build_dspbench``)
against the literal plain-PyTorch transcription
(``reference/fraud_dspbench.py``), on the CPU, and the stateful step's
O(batch) contract (``ops/gpu_stateful.py``).

* Graph level, through ``PipeGraph.run()``: frames of seeded ``(card,
  state)`` transactions under EVENT time, the Markov model a seeded
  Dirichlet(12) matrix; cards fewer and more than a batch, a log replayed
  so that windows straddle batches and replays, one card holding dozens
  of a batch's lanes (the wavefront runs that many passes), DSPBench's
  window and threshold and one other value of each, the megastep plane
  (K = 8) and the per-batch route.
* The comparison (``wfbench/reference/fraud.py``'s): the alert sets
  ``(card, index)`` equal, each alert's window of states equal, each
  score within 1e-6 of the float64 score; transactions scoring within
  1e-6 of the threshold are excused from set membership.  The program's
  score is float32 with four float32 table entries added (error about
  1e-7); a score rounded to bfloat16 or float16 fails.
* The benchmark's blocked numpy reference equals the literal one.
* Scale: a wavefront step over a table of 2^22 slots and a batch of 4,096
  allocates nothing with as many rows as the table, and leaves the table
  where it was; the device counters of ``stats()["Stateful"]``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import windflow_tpu_torch as wt
from reference import fraud_dspbench as literal
from wfbench.reference import fraud as blocked
from windflow_tpu_torch.models import fraud_detection as fd
from windflow_tpu_torch.ops import gpu_stateful as gst

torch.set_num_threads(1)

#: the comparison's tolerance (see wfbench/reference/fraud.py)
TOL = blocked.SCORE_TOL
FRAME = np.dtype([("key", "<i8"), ("ts", "<i8"), ("v", "<f8", (2,))])


def _model(seed, states=fd.DSPBENCH_STATES, alpha=12.0):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(states, alpha), size=states)


def _log(seed, n, cards, hot_share=0.0, states=fd.DSPBENCH_STATES):
    """``n`` transactions: cards uniform below ``cards`` (a share
    ``hot_share`` of them on card 7), states uniform."""
    rng = np.random.default_rng(seed)
    card = rng.integers(0, cards, n)
    card[rng.random(n) < hot_share] = 7
    return card, rng.integers(0, states, n)


def _frames(card, state):
    f = np.zeros(len(card), FRAME)
    f["key"] = card
    f["ts"] = np.arange(len(card))         # ts names the record
    f["v"][:, 0] = np.arange(len(card))    # the transaction id
    f["v"][:, 1] = state
    return f.tobytes()


def _run(card, state, transition, *, cards, batch, window=5,
         threshold=0.96, k=1, graph_out=None):
    """The graph over the transactions; returns ``(index, card, score,
    states [n, window])`` of the alerts."""
    blob = _frames(card, state)

    def chunks():
        for i in range(0, len(blob), 16384):
            yield blob[i:i + 16384]
    got = []

    def sink(cols, ctx=None):
        if cols is not None:
            got.append((np.asarray(cols.tss), np.asarray(cols.cols["card"]),
                        np.asarray(cols.cols["score"]),
                        np.stack([np.asarray(cols.cols[f"s{i}"])
                                  for i in range(window)], 1)))
    src = wt.FrameSource(chunks, nv=2, fields=["transaction_id", "state"],
                         output_batch_size=batch)
    g = fd.build_dspbench(src, transition, sink, cards=cards, window=window,
                          threshold=threshold,
                          config=wt.Config(device="cpu",
                                           punctuation_interval_usec=10**12,
                                           megastep_sweeps=k))
    g.run()
    if graph_out is not None:
        graph_out.append(g)
    if not got:
        return (np.zeros(0, np.int64),) * 3 + (np.zeros((0, window)),)
    return tuple(np.concatenate(a) for a in zip(*got))


def mismatches(got, scored, threshold):
    """The comparison's count against the literal reference's scored
    events (``predict``): alerts missing or extra (borderline excused),
    alerts repeated, windows or cards unequal, scores off by more than
    ``TOL``."""
    index, card, score, states = got
    by_index = {s["index"]: s for s in scored}
    want = {s["index"] for s in scored
            if s["score"] > threshold and abs(s["score"] - threshold) > TOL}
    border = {s["index"] for s in scored
              if abs(s["score"] - threshold) <= TOL}
    bad = len(index) - len(set(index.tolist()))
    have = set(index.tolist())
    bad += len(want - have) + len(have - want - border)
    for i, c, sc, st in zip(index.tolist(), card.tolist(), score.tolist(),
                            states.tolist()):
        ref = by_index.get(i)
        if ref is None:
            continue
        bad += int(c != ref["card"]) + int(tuple(st) != ref["states"])
        bad += int(abs(sc - ref["score"]) > TOL)
    return bad


#: (name, cards, batch, records, replays, hot share, window, threshold, K)
CASES = [
    ("cards_below_batch", 40, 256, 4096, 1, 0.0, 5, 0.96, 1),
    ("cards_below_batch_k8", 40, 256, 4096, 1, 0.0, 5, 0.96, 8),
    ("cards_above_batch", 1200, 256, 12000, 1, 0.0, 5, 0.96, 1),
    ("cards_above_batch_k8", 1200, 256, 12000, 1, 0.0, 5, 0.96, 8),
    ("replays", 500, 256, 1500, 3, 0.0, 5, 0.96, 8),
    ("hot_card", 400, 256, 4096, 1, 0.1, 5, 0.96, 8),
    ("hot_card_per_batch", 400, 256, 4096, 1, 0.1, 5, 0.96, 1),
    ("window_4", 300, 256, 4000, 1, 0.0, 4, 0.96, 8),
    ("window_8_int64_word", 200, 256, 4096, 1, 0.0, 8, 0.95, 8),
    ("threshold_0.9", 300, 256, 4000, 1, 0.0, 5, 0.9, 8),
]


@pytest.mark.parametrize(
    "cards,batch,n,replays,hot,window,threshold,k",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_dspbench_graph_matches_literal_reference(cards, batch, n, replays,
                                                  hot, window, threshold,
                                                  k):
    transition = _model(cards + n)
    card, state = _log(n + replays, n, cards, hot)
    card, state = np.tile(card, replays), np.tile(state, replays)
    graphs = []
    got = _run(card, state, transition, cards=cards, batch=batch,
               window=window, threshold=threshold, k=k, graph_out=graphs)
    scored = literal.predict(zip(card.tolist(), state.tolist()), transition,
                             window=window, threshold=threshold)
    assert sum(s["outlier"] for s in scored) > 10     # the case has alerts
    assert mismatches(got, scored, threshold) == 0
    st = graphs[0].stats()
    counts = st["Stateful"]["markov_predictor"]
    assert counts["lanes"] == len(card)
    if k > 1:
        edge = st["Megastep"]["edges"][0]
        assert st["Megastep"]["refused"] == [] and edge["megasteps"] > 0
    if hot:
        # card 7 holds ~10% of each batch: the wavefront runs that deep
        assert counts["passes"] >= 8 * counts["batches"]


def test_low_precision_scores_fail_the_comparison():
    """A score rounded to bfloat16 (or float16) before the threshold, in
    the program's place, reads not correct; float32 rounding does not."""
    transition = _model(1)
    card, state = _log(2, 8000, 300)
    scored = literal.predict(zip(card.tolist(), state.tolist()), transition)
    for dtype, fails in ((torch.bfloat16, True), (torch.float16, True),
                         (torch.float32, False)):
        sc = torch.tensor([s["score"] for s in scored],
                          dtype=torch.float64).to(dtype).double().numpy()
        keep = sc > 0.96
        rows = [s for s, kp in zip(scored, keep) if kp]
        got = (np.array([s["index"] for s in rows], np.int64),
               np.array([s["card"] for s in rows], np.int64),
               sc[keep], np.array([s["states"] for s in rows]))
        assert (mismatches(got, scored, 0.96) > 0) == fails, dtype


def test_benchmark_reference_equals_literal():
    """``wfbench/reference/fraud.py`` (blocked numpy, a cyclic window over
    each card's log sequence) against the literal predictor over the
    replayed stream: the same alerts, windows and scores; the control
    (bfloat16 score) reads not correct."""
    cfg = {"window": 5, "threshold": 0.96}
    n, gap, total = 3000, 7, 7500                 # 2.5 replays
    transition = _model(3)
    card, state = _log(4, n, 300)
    values = np.stack([np.arange(n, dtype=np.float64),
                       state.astype(np.float64)], 1)
    stream = np.arange(total) % n
    scored = literal.predict(zip(card[stream].tolist(),
                                 state[stream].tolist()), transition)
    out = [s for s in scored if s["outlier"]]
    got = (np.array([s["card"] for s in out]),
           np.array([s["index"] * gap for s in out]),
           np.array([s["score"] for s in out], np.float32),
           blocked.pack_states([s["states"] for s in out]))
    tables = {"transition": transition}
    checks, index, due = blocked.check(cfg, tables, card, values, gap, total,
                                       got)
    assert checks["alerts_mismatched"][0] == 0
    assert checks["score_abs_err_max"][0] <= 1e-7
    assert due == len(out) and (index >= 0).all()
    win, score, _, _ = blocked.log_windows(cfg, tables, card, values)
    for s in scored:
        j = s["index"] % n
        assert tuple(win[j]) == s["states"]
        assert abs(score[j] - s["score"]) <= 1e-12
    for dtype in ("bfloat16", "float16"):
        ctl = blocked.control(cfg, tables, card, values, gap, total, dtype)
        checks = blocked.check(cfg, tables, card, values, gap, total, ctl)[0]
        assert any(v > lim for v, lim in checks.values()), dtype


def test_state_word_packing():
    """DSPBench's window packs in one int32 word; a wider one in int64;
    one too wide for 63 bits is refused."""
    assert fd.state_word(5, 18) == (torch.int32, 5, 3)
    assert fd.state_word(9, 18)[0] is torch.int64
    with pytest.raises(ValueError):
        fd.state_word(16, 18)
    m = _model(0)
    assert np.allclose(fd.miss_table(m), 1.0 - m, atol=1e-15)


# ---------------------------------------------------------------------------
# the stateful step's O(batch) contract and its device counters
# ---------------------------------------------------------------------------

class _Outputs(TorchDispatchMode):
    """Every op's output tensors: ``(op name, storage address, storage
    elements)``."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.seen.append((str(func), st.data_ptr(),
                                  st.nbytes() // t.element_size()))
        return out


@pytest.mark.parametrize("loop", [True, False], ids=["loop", "host_loop"])
def test_wavefront_step_is_o_batch(loop):
    """A step over 2^22 slots and 4,096 lanes: no op outputs new storage
    of 2^22 or more elements (updates of the table and views of it
    aside), and the table stays where it was."""
    S, cap = 1 << 22, 4096
    rng = np.random.default_rng(5)
    state = gst._state_table(np.int32(0), S)
    ptr = state.data_ptr()
    slots = torch.from_numpy(rng.integers(0, S, cap).astype(np.int32))
    slots[:6] = 9                          # a card with six lanes
    payload = {"key": slots.clone(),
               "v": torch.from_numpy(rng.integers(0, 9, cap)
                                     .astype(np.int32))}
    valid = torch.ones(cap, dtype=torch.bool)

    def fn(t, s):
        return {"key": t["key"], "prev": s}, s + t["v"]
    body = gst._wavefront_body(fn, cap, S, False, loop=loop)
    with _Outputs() as mode:
        new, out, _ = body(state, payload, valid, slots)
    table = state.untyped_storage().data_ptr()
    big = [(op, n) for op, p, n in mode.seen if n >= S and p != table]
    assert big == []
    assert new is state and new.data_ptr() == ptr
    assert int(new[9]) == int(payload["v"][:6].sum())
    assert body.last_depth == 6
    batches, passes, lanes = body.counts[torch.device("cpu")].tolist()
    assert (batches, passes, lanes) == (1, 6, cap)


def test_plain_table_is_copied_not_updated():
    """A table without the dump row (a mesh shard's, a caller's) is left
    as it was: the step returns a new one, as the JAX package's body."""
    S, cap = 64, 32
    state = torch.arange(S, dtype=torch.int32)
    before = state.clone()
    slots = torch.arange(cap, dtype=torch.int32) % 8
    body = gst._wavefront_body(lambda t, s: (t, s + 1), cap, S, False,
                               loop=True)
    new, _, _ = body(state, {"key": slots}, torch.ones(cap, dtype=bool),
                     slots)
    assert torch.equal(state, before)
    assert torch.equal(new[:8], before[:8] + cap // 8)


def test_restored_table_keeps_its_dump_row():
    """``restore_state`` places the blob's table with a dump row, so the
    steps after a restore update it in place."""
    op = (wt.MapGPU_Builder(lambda t, s: (t, s + 1))
          .withInitialState(np.int32(0)).withKeyBy(lambda t: t["key"])
          .withNumKeySlots(16).withDenseKeys().build())
    op.config = wt.Config(device="cpu")
    blob = op.snapshot_state()
    blob["state"] = np.arange(16, dtype=np.int32)
    op.restore_state(blob)
    assert gst._dump_tables(op._state, 16) is not None
    assert op._state.tolist() == list(range(16))


def test_stateful_counts_passes_and_lanes():
    """One batch of 64 transactions in which card 3 holds five lanes and
    every other card one: ``stats()["Stateful"]`` reads 1 batch, 5
    passes, 64 lanes."""
    card = np.r_[[3] * 5, np.arange(10, 69)]
    state = np.zeros(64, np.int64)
    graphs = []
    _run(card, state, _model(0), cards=100, batch=64, graph_out=graphs)
    assert graphs[0].stats()["Stateful"] == {
        "markov_predictor": {"batches": 1, "passes": 5, "lanes": 64}}
