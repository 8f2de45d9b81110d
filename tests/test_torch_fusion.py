"""Whole-chain fusion of the port (windflow_tpu_torch/fusion) against the
JAX package, on the CPU.

Each family runs the same seeded stream through the port's
``PipeGraph.run()`` fused and unfused (``Config.whole_chain_fusion``) and
through the JAX package's fused graph, built the way
tests/test_fusion.py builds it (``.add(map).add(filter)``, not
``.chain``).  Families: count windows (generic and ``withSumCombiner``),
time windows, the keyed reduce on its sorted, dense and bounded
compacted routes, the dense-key stateful tail and the interning one
(whose stateless prefix alone fuses), and an all-stateless chain; a
split graph and merged sources; the segment names; one tail step a
batch and none on the members; the kill switch; the keys lane a chain forwards into a KEYBY
consumer at one and several replicas; member stats; closing functions;
the port's ``entry()`` step against ``__graft_entry__.entry()``'s.

Tolerances: integer-valued data equal record for record (fused, unfused
and JAX); random floats rtol 1e-5 against JAX (XLA on the CPU contracts
the map's ``v * 1.5 + 1.0`` into one fused multiply-add where torch
rounds twice: ROADMAP §C parity notes), still equal fused to unfused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

CAP = 64
N = CAP * 6
N_KEYS = 8
MAX = {wf: jnp.maximum, wt: torch.maximum}


def _cfg(pkg, fuse, **kw):
    if pkg is wt:
        return wt.Config(device="cpu", whole_chain_fusion=fuse, **kw)
    return dataclasses.replace(wf.basic.default_config,
                               whole_chain_fusion=fuse, **kw)


def _dev(pkg, kind):
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


def _rec(r):
    return tuple(sorted((k, float(v)) for k, v in r.items()))


def _records_sink(pkg, got):
    return pkg.Sink_Builder(
        lambda r: got.append(_rec(r)) if r is not None else None) \
        .withName("snk").build()


def _data(floats=False, n=N, seed=0):
    rng = np.random.default_rng(seed)
    keys = (np.arange(n) % N_KEYS).astype(np.int32)
    vals = (rng.random(n) if floats else np.arange(n)).astype(np.float32)
    return [{"key": k, "v": v, "ts": np.int64(i * 1000)}
            for i, (k, v) in enumerate(zip(keys, vals))]


def _source(pkg, items, event=False, name="src"):
    b = pkg.Source_Builder(lambda: iter(items)).withName(name) \
        .withOutputBatchSize(CAP)
    if event:
        b = b.withTimestampExtractor(lambda t: t["ts"])
    return b.build()


def _map_filter(pkg, floats=False):
    if floats:
        mfn = lambda t: {"key": t["key"], "v": t["v"] * 1.5 + 1.0}  # noqa
    else:
        mfn = lambda t: {"key": t["key"], "v": t["v"] * 2.0}  # noqa
    ma = _dev(pkg, "Map")(mfn).withName("ma").build()
    fb = _dev(pkg, "Filter")(lambda t: (t["key"] & 1) == 0) \
        .withName("fb").build()
    return ma, fb


def _tail(pkg, kind, par=1):
    if kind.startswith("cb_window") or kind == "tb_window":
        wb = (_dev(pkg, "Ffat_Windows")(lambda t: t["v"], lambda a, b: a + b)
              .withKeyBy(lambda t: t["key"]).withMaxKeys(N_KEYS)
              .withParallelism(par).withName("win"))
        if kind == "tb_window":
            return wb.withTBWindows(16_000, 8_000).build()
        wb = wb.withCBWindows(8, 4)
        return (wb.withSumCombiner() if kind == "cb_window_sum"
                else wb).build()
    if kind.startswith("reduce"):
        mx = MAX[pkg]
        rb = (_dev(pkg, "Reduce")(
            lambda a, b: {"key": mx(a["key"], b["key"]),
                          "v": mx(a["v"], b["v"])})
            .withKeyBy(lambda t: t["key"]).withParallelism(par)
            .withName("red"))
        if kind in ("reduce_dense", "reduce_compacted"):
            rb = rb.withMaxKeys(N_KEYS).withMonoidCombiner("max")
        return rb.build()
    if kind.startswith("stateful"):
        # dense keys fuse as a tail; the interning tail does not (its
        # distinct keys go to the host before the step): the prefix fuses
        sb = (_dev(pkg, "Map")(
            lambda t, s: ({"key": t["key"], "v": t["v"] + s}, s + 1.0))
            .withInitialState(np.float32(0.0))
            .withKeyBy(lambda t: t["key"]).withNumKeySlots(N_KEYS * 2)
            .withParallelism(par).withName("sm"))
        return (sb.withDenseKeys() if kind == "stateful_dense"
                else sb).build()
    assert kind == "stateless"
    return None


def _run_family(pkg, kind, fuse, floats=False, par=1):
    got = []
    event = kind == "tb_window"
    kw = {"key_compaction": False} if kind == "reduce_dense" else {}
    g = pkg.PipeGraph(f"fuse_{kind}", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT if event
                      else pkg.TimePolicy.INGRESS,
                      config=_cfg(pkg, fuse, **kw))
    p = g.add_source(_source(pkg, _data(floats), event))
    ma, fb = _map_filter(pkg, floats)
    p.add(ma)
    p.add(fb)
    tl = _tail(pkg, kind, par)
    if tl is not None:
        p.add(tl)
    p.add_sink(_records_sink(pkg, got))
    g.run()
    return sorted(got), g


def _close(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [k for k, _ in ra] == [k for k, _ in rb]
        np.testing.assert_allclose([v for _, v in ra], [v for _, v in rb],
                                   rtol=1e-5)


KINDS = ["cb_window", "cb_window_sum", "tb_window", "reduce_sorted",
         "reduce_dense", "reduce_compacted", "stateful_dense",
         "stateful_intern", "stateless"]


@pytest.mark.parametrize("kind", KINDS)
def test_fused_equals_unfused_and_the_jax_package(kind):
    unfused, _ = _run_family(wt, kind, fuse=False)
    fused, g = _run_family(wt, kind, fuse=True)
    jax_fused, gj = _run_family(wf, kind, fuse=True)
    assert fused == unfused
    assert fused == jax_fused and len(fused) > 0
    segs = [s["name"] for s in g._fused_segments]
    # the segment names of tests/test_fusion.py:128-140, and the JAX
    # package's own
    assert segs == [s["name"] for s in gj._fused_segments]
    if kind in ("stateless", "stateful_intern"):
        assert segs == ["ma|fb"]    # stateful_intern: the prefix only
    else:
        assert len(segs) == 1 and segs[0].startswith("ma|fb|")
    if kind == "reduce_compacted":
        assert g._operators[-2].bounded_compaction
    if kind == "stateful_dense":
        assert segs == ["ma|fb|sm"]
        assert g._operators[-2]._fused_prelude is not None
    if kind == "stateful_intern":
        sm = g._operators[-2]
        # the tail keeps its own hop; fed by a device edge, it interns
        assert sm._fused_prelude is None and sm._compactor is None
        assert len(sm._interner) == N_KEYS // 2


@pytest.mark.parametrize("kind", ["cb_window", "reduce_sorted",
                                  "stateless"])
def test_fused_equals_unfused_on_random_floats(kind):
    unfused, _ = _run_family(wt, kind, fuse=False, floats=True)
    fused, _ = _run_family(wt, kind, fuse=True, floats=True)
    jax_fused, _ = _run_family(wf, kind, fuse=True, floats=True)
    assert fused == unfused
    _close(fused, jax_fused)


def _split_graph(pkg, fuse):
    got = [[], []]
    g = pkg.PipeGraph("fuse_split", config=_cfg(pkg, fuse))
    p = g.add_source(_source(pkg, _data()))
    p.add(_dev(pkg, "Map")(lambda t: {"key": t["key"], "v": t["v"] + 1.0})
          .withName("pre").build())
    p.split(lambda t: t["key"] % 2, 2)
    for b in range(2):
        br = p.select(b)
        br.add(_dev(pkg, "Map")(
            lambda t: {"key": t["key"], "v": t["v"] * 3.0})
            .withName(f"m{b}").build())
        br.add(_dev(pkg, "Filter")(lambda t: (t["key"] & 3) != 3)
               .withName(f"f{b}").build())
        br.add_sink(pkg.Sink_Builder(
            lambda r, _b=b: got[_b].append(_rec(r))
            if r is not None else None).build())
    g.run()
    return [sorted(x) for x in got], g


def test_fused_equals_unfused_split_graph():
    """Fusion stops at the split yet fuses the runs inside each branch."""
    a, _ = _split_graph(wt, False)
    b, g = _split_graph(wt, True)
    c, _ = _split_graph(wf, True)
    assert a == b == c and all(len(x) for x in a)
    assert sorted(s["name"] for s in g._fused_segments) == ["m0|f0", "m1|f1"]


def _merged_graph(pkg, fuse):
    got = []
    g = pkg.PipeGraph("fuse_merge", config=_cfg(pkg, fuse))
    p1 = g.add_source(_source(pkg, _data(n=N // 2)))
    p2 = g.add_source(_source(pkg, [{"key": np.int32(i % N_KEYS),
                                     "v": np.float32(1000 + i)}
                                    for i in range(N // 2)], name="src2"))
    merged = p1.merge(p2)
    ma, fb = _map_filter(pkg)
    merged.add(ma)
    merged.add(fb)
    merged.add(_tail(pkg, "cb_window"))
    merged.add_sink(_records_sink(pkg, got))
    g.run()
    return sorted(got), g


def test_fused_equals_unfused_merged_sources():
    """A merge feeding the chain head: the merge edge redirects into the
    fused host like any other edge."""
    a, _ = _merged_graph(wt, False)
    b, g = _merged_graph(wt, True)
    c, _ = _merged_graph(wf, True)
    assert a == b == c and len(a) > 0
    assert [s["name"] for s in g._fused_segments] == ["ma|fb|win"]


def _count_steps(op):
    """Count ``op``'s data steps (the replica's per-batch call)."""
    calls = []
    orig = op._step

    def step(batch, *args):
        calls.append(1)
        return orig(batch, *args)
    op._step = step
    return calls


@pytest.mark.parametrize("kind", ["cb_window", "tb_window",
                                  "reduce_compacted", "stateful_dense"])
def test_one_tail_step_a_batch_and_none_on_members(kind):
    for fuse in (True, False):
        g = wt.PipeGraph("steps", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT if kind == "tb_window"
                         else wt.TimePolicy.INGRESS,
                         config=_cfg(wt, fuse))
        p = g.add_source(_source(wt, _data(), kind == "tb_window"))
        ma, fb = _map_filter(wt)
        tl = _tail(wt, kind)
        calls = {op.name: _count_steps(op) for op in (ma, fb, tl)}
        p.add(ma).add(fb).add(tl).add_sink(
            wt.Sink_Builder(lambda r: None).build())
        g.run()
        n_batches = N // CAP
        if fuse:
            assert {k: len(v) for k, v in calls.items()} == \
                {"ma": 0, "fb": 0, tl.name: n_batches}
            # the members' replicas ran nothing and read as terminated
            for m in (ma, fb):
                for rep in m.replicas:
                    assert rep.stats.device_programs_launched == 0
                    assert rep.done and rep.stats.is_terminated
        else:
            # the kill switch: every hop steps every batch again
            assert g._fused_segments == []
            assert {k: len(v) for k, v in calls.items()} == \
                {"ma": n_batches, "fb": n_batches, tl.name: n_batches}


def test_stateless_segment_steps_once_a_batch_on_its_last_member():
    _, g = _run_family(wt, "stateless", fuse=True)
    ops = {o.name: o for o in g._operators}
    assert ops["fb"]._fusion_exec is not None
    assert sum(r.stats.device_programs_launched
               for r in ops["fb"].replicas) == N // CAP
    assert sum(r.stats.device_programs_launched
               for r in ops["ma"].replicas) == 0


def _keyed_consumer_graph(chained, par=1, fuse=False):
    """Map → Filter (chained or added) → keyed ReduceGPU: the chain (or
    the fused stateless segment) forwards the consumer's keys."""
    got, seen_keys = [], []
    ma, fb = _map_filter(wt)
    red = _tail(wt, "reduce_sorted", par)
    orig = red._step

    def spy(batch):
        seen_keys.append(batch.keys is not None)
        return orig(batch)
    red._step = spy
    g = wt.PipeGraph("keys_lane", config=_cfg(wt, fuse))
    p = g.add_source(_source(wt, _data()))
    p.add(ma)
    (p.chain if chained else p.add)(fb)
    p.add(red).add_sink(_records_sink(wt, got))
    g.run()
    return sorted(got), seen_keys, g


def test_keyby_after_chain_carries_the_keys_lane():
    """One replica: a chained Map|Filter feeding a KEYBY reduce extracts
    the reduce's keys on its output records and ships them; the records
    equal the unchained graph's."""
    chained, keys_seen, _ = _keyed_consumer_graph(chained=True)
    unchained, keys_unseen, _ = _keyed_consumer_graph(chained=False)
    assert chained == unchained and len(chained) > 0
    assert all(keys_seen) and len(keys_seen) == N // CAP
    assert not any(keys_unseen)


@pytest.mark.parametrize("par", [2, 3])
def test_keyby_after_fused_chain_multi_replica_routing(par):
    """Several replicas: the fused stateless segment forwards the keys
    lane, the device keyby emitter places by it, every key lands on one
    replica, and the records equal the single-replica run's and the JAX
    package's."""
    base, _, _ = _keyed_consumer_graph(chained=False, par=1, fuse=True)
    multi, keys_seen, g = _keyed_consumer_graph(chained=False, par=par,
                                                fuse=True)
    assert [s["name"] for s in g._fused_segments] == ["ma|fb"]
    assert multi == base and all(keys_seen)
    jx, _ = _run_family(wf, "reduce_sorted", fuse=True, par=par)
    assert multi == jx


def test_member_stats_attributed_from_fused_hop():
    _, g = _run_family(wt, "cb_window", fuse=True)
    ops = {o["Operator_name"]: o for o in g.stats()["Operators"]}
    assert ops["ma"]["Fused_into"] == "ma|fb|win"
    assert ops["fb"]["Fused_into"] == "ma|fb|win"
    assert "Fused_into" not in ops["win"]
    host_inputs = sum(r["Inputs_received"] for r in ops["win"]["Replicas"])
    assert host_inputs == N
    assert sum(r["Inputs_received"] for r in ops["ma"]["Replicas"]) == N
    assert all(r["Is_terminated"] for r in ops["fb"]["Replicas"])


def test_closing_functions_run_once_in_a_fused_segment():
    closed = []
    g = wt.PipeGraph("closers", config=_cfg(wt, True))
    p = g.add_source(_source(wt, _data()))
    ma = (wt.MapGPU_Builder(lambda t: {"key": t["key"], "v": t["v"]})
          .withName("ma").withClosingFunction(lambda: closed.append("ma"))
          .build())
    fb = (wt.FilterGPU_Builder(lambda t: t["v"] >= 0).withName("fb")
          .withClosingFunction(lambda ctx: closed.append(
              (ctx.operator_name, "fb"))).build())
    win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
           .withCBWindows(8, 4).withKeyBy(lambda t: t["key"])
           .withMaxKeys(N_KEYS).withName("win")
           .withClosingFunction(lambda: closed.append("win")).build())
    p.add(ma).add(fb).add(win).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    g.run()
    assert [s["name"] for s in g._fused_segments] == ["ma|fb|win"]
    assert closed == ["ma", ("win", "fb"), "win"]


def test_entry_step_matches_the_jax_entry():
    """The port's flagship step (Map → Filter → FFAT CB sum) against
    ``__graft_entry__.entry()``'s on the same numpy inputs, ten steps
    from the zero state (windows of 128 fire from the eighth batch on):
    fired masks equal, fired values within rtol 1e-5 (the map's fused
    multiply-add on XLA), keys, window ids and timestamps equal."""
    import __graft_entry__ as ge
    from windflow_tpu_torch.entry import entry
    jstep, jargs = ge.entry()
    tstep, targs = entry(device="cpu")
    for a, b in zip(jargs[1:], targs[1:]):
        la, lb = (jax.tree.leaves(a), [b] if isinstance(b, torch.Tensor)
                  else [b[k] for k in sorted(b)])
        for x, y in zip(la, lb):
            assert np.array_equal(np.asarray(x), y.numpy())
    jstate, tstate = jargs[0], targs[0]
    jf = jax.jit(jstep)
    n_fired = 0
    for _ in range(10):
        jstate, jout, jfired, jts = jf(jstate, *jargs[1:])
        tstate, tout, tfired, tts = tstep(tstate, *targs[1:])
        fired = np.asarray(jfired)
        assert np.array_equal(fired, tfired.numpy())
        n_fired += int(fired.sum())
        for name in ("key", "wid"):
            assert np.array_equal(np.asarray(jout[name])[fired],
                                  tout[name].numpy()[fired])
        np.testing.assert_allclose(np.asarray(jout["value"])[fired],
                                   tout["value"].numpy()[fired], rtol=1e-5)
        assert np.array_equal(np.asarray(jts)[fired], tts.numpy()[fired])
    assert n_fired > 0
