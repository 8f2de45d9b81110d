"""The persistent operator suite of the port (``windflow_tpu_torch/
persistent/{db_handle,ops,p_windows,builders}.py``) against the JAX
package's, on the operator tests of tests/test_persistent.py, plus state
carried across the packages: a store one package's ``P_Reduce`` kept
reopens under the other's and goes on with equal state.

Every comparison is exact (integer state, integer window sums).  The port
runs on ``Config(device="cpu")``; the suite runs on the host in both.
"""

import random

import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import persistent as jp
from windflow_tpu_torch import persistent as tp

torch.set_num_threads(1)


def cfg(pkg):
    return wt.Config(device="cpu") if pkg is wt else wf.Config()


def P(pkg):
    return tp if pkg is wt else jp


def _stream(n_keys, length):
    return [{"key": i % n_keys, "value": i} for i in range(length)]


# ---------------------------------------------------------------------------
# DBHandle and SpillingArchive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [wf, wt], ids=["jax", "port"])
def test_db_handle_typed_keys_and_initial_state(tmp_path, pkg):
    db = P(pkg).DBHandle(str(tmp_path / "db"),
                         initial_state=lambda: {"n": 0}, delete_db=False)
    assert db.get(42) == {"n": 0}
    s = db.get("alpha")
    s["n"] = 7
    db.put("alpha", s)
    db.put((1, "compound"), {"n": 3})
    db.put(b"raw", {"n": 1})
    assert db.get("alpha") == {"n": 7}
    assert db.lookup("beta") is None
    assert sorted(map(str, db.keys())) == sorted(
        map(str, ["alpha", (1, "compound"), b"raw"]))
    db.close()
    db2 = P(pkg).DBHandle(str(tmp_path / "db2"), initial_state={"n": 0})
    a, b = db2.get(1), db2.get(2)
    a["n"] = 99
    assert b["n"] == 0
    db2.close()


def test_db_handle_store_reads_across_packages(tmp_path):
    """A store one package's handle wrote reads back, key for key, under
    the other's: the same key encoding, the same log."""
    keys = [7, -3, "alpha", b"raw", (1, "compound")]
    for writer, reader in ((jp, tp), (tp, jp)):
        path = str(tmp_path / writer.__name__)
        db = writer.DBHandle(path, delete_db=False, whoami=1)
        for i, k in enumerate(keys):
            db.put(k, {"n": i})
        db.delete(-3)
        db.close()
        db = reader.DBHandle(path, delete_db=True, whoami=1)
        assert sorted(map(repr, db.keys())) == sorted(
            map(repr, [k for k in keys if k != -3]))
        for i, k in enumerate(keys):
            assert db.lookup(k) == (None if k == -3 else {"n": i})
        db.close()
    assert tp.DBHandle.key_bytes(12) == jp.DBHandle.key_bytes(12)
    assert tp.DBHandle.key_bytes("x") == jp.DBHandle.key_bytes("x")


@pytest.mark.parametrize("pkg", [wf, wt], ids=["jax", "port"])
def test_spilling_archive_spills_and_reloads(tmp_path, pkg):
    db = P(pkg).DBHandle(str(tmp_path / "arch"), delete_db=True)
    arch = P(pkg).SpillingArchive(db, key=7, n_max=4)
    for i in range(19):
        arch.insert((i, i, {"v": i}, i))
    assert arch.spilled_fragments >= 3
    assert len(arch) == 19
    assert [e[0] for e in arch.range(5, 15)] == list(range(5, 15))
    arch.purge_below(8)
    assert [e[0] for e in arch.range(0, 100)] == list(range(8, 19))
    arch.clear()
    assert len(arch) == 0
    assert len(db) == 0
    db.close()


def test_spilling_archive_out_of_order_equals_jax(tmp_path):
    order = [5, 1, 9, 2, 8, 0, 7, 3, 6, 4]
    got = {}
    for pkg in (wf, wt):
        db = P(pkg).DBHandle(str(tmp_path / pkg.__name__), delete_db=True)
        arch = P(pkg).SpillingArchive(db, key=0, n_max=3)
        for aid, d in enumerate(order):
            arch.insert((d, aid, d, d))
        got[pkg] = (arch.range(0, 10), arch.range(3, 7),
                    arch.spilled_fragments, len(arch))
        db.close()
    assert got[wt] == got[wf]
    assert [e[0] for e in got[wt][0]] == sorted(order)


# ---------------------------------------------------------------------------
# the operators in graphs
# ---------------------------------------------------------------------------

class Acc:
    def __init__(self):
        self.items = []

    def __call__(self, item, ctx=None):
        if item is not None:
            self.items.append(item)


def run_pmap(pkg, tmp_path, par, run_id, length=400, n_keys=6):
    acc = Acc()

    def stamp(t, state):
        state["seen"] = state.get("seen", 0) + 1
        return {"key": t["key"], "value": t["value"] + state["seen"]}

    src = (pkg.Source_Builder(lambda: iter(_stream(n_keys, length)))
           .withName("src").build())
    pm = (P(pkg).P_Map_Builder(stamp).withName("pmap").withParallelism(par)
          .withKeyBy(lambda t: t["key"])
          .withDBPath(str(tmp_path / f"{pkg.__name__}_pmap_{run_id}"))
          .withInitialState(dict).build())
    snk = pkg.Sink_Builder(acc).withName("sink").build()
    g = pkg.PipeGraph(f"p_map_{run_id}", pkg.ExecutionMode.DEFAULT,
                      config=cfg(pkg))
    g.add_source(src).add(pm).add_sink(snk)
    g.run()
    return acc.items


def test_p_map_metamorphic(tmp_path):
    rnd = random.Random(3)
    length, n_keys = 400, 6
    occ, extra = divmod(length, n_keys)
    expected = sum(range(length))
    for k in range(n_keys):
        n = occ + (1 if k < extra else 0)
        expected += n * (n + 1) // 2
    for run in range(4):
        par = rnd.randint(1, 4)
        got = run_pmap(wt, tmp_path, par, run)
        want = run_pmap(wf, tmp_path, par, run)
        key = lambda r: (r["key"], r["value"])    # noqa: E731
        assert sorted(got, key=key) == sorted(want, key=key)
        assert sum(r["value"] for r in got) == expected


def _filter_flatmap(pkg, tmp_path, tag):
    acc = Acc()

    def keep_every_third(t, state):
        state["n"] = state.get("n", 0) + 1
        return state["n"] % 3 == 0

    def fan(t, state, shipper):
        state["n"] = state.get("n", 0) + 1
        for i in range(state["n"] % 3):
            shipper.push({"key": t["key"], "value": t["value"] * 10 + i})

    src = pkg.Source_Builder(lambda: iter(_stream(5, 300))).build()
    flt = (P(pkg).P_Filter_Builder(keep_every_third).withName("pf")
           .withKeyBy(lambda t: t["key"]).withParallelism(2)
           .withDBPath(str(tmp_path / f"{pkg.__name__}_{tag}_f"))
           .withInitialState(dict).build())
    fm = (P(pkg).P_FlatMap_Builder(fan).withName("pfm")
          .withKeyBy(lambda t: t["key"]).withParallelism(3)
          .withDBPath(str(tmp_path / f"{pkg.__name__}_{tag}_fm"))
          .withInitialState(lambda: {"n": 0}).build())
    g = pkg.PipeGraph("pf", pkg.ExecutionMode.DETERMINISTIC,
                      config=cfg(pkg))
    g.add_source(src).add(flt).add(fm).add_sink(
        pkg.Sink_Builder(acc).build())
    g.run()
    return acc.items


def test_p_filter_and_p_flatmap_equal_jax(tmp_path):
    got = _filter_flatmap(wt, tmp_path, "a")
    assert got == _filter_flatmap(wf, tmp_path, "a")
    assert len(got) > 50


def _p_reduce_run(pkg, db_path, n=100, n_keys=4, start=0):
    out = []

    def count(t, state):
        state["n"] = state.get("n", 0) + 1
        state["sum"] = state.get("sum", 0) + t["value"]

    data = [{"key": i % n_keys, "value": start + i} for i in range(n)]
    src = pkg.Source_Builder(lambda: iter(data)).withName("src").build()
    red = (P(pkg).P_Reduce_Builder(count).withName("preduce")
           .withKeyBy(lambda t: t["key"]).withDBPath(db_path)
           .withInitialState(dict).withKeepDb().build())
    snk = pkg.Sink_Builder(
        lambda t, ctx=None: out.append(dict(t)) if t is not None
        else None).withName("s").build()
    g = pkg.PipeGraph("p_reduce", pkg.ExecutionMode.DEFAULT,
                      config=cfg(pkg))
    g.add_source(src).add(red).add_sink(snk)
    g.run()
    return out


def _db_state(db_path):
    db = tp.DBHandle(db_path, initial_state=dict, delete_db=False, whoami=0)
    state = {k: db.get(k) for k in db.keys()}
    db.close()
    return state


def test_p_reduce_state_survives_restart(tmp_path):
    """withKeepDb: a second run resumes from the first run's keyed state,
    in both packages alike."""
    for pkg in (wf, wt):
        db_path = str(tmp_path / pkg.__name__)
        _p_reduce_run(pkg, db_path)
        _p_reduce_run(pkg, db_path)
        st = _db_state(db_path)
        assert sum(s["n"] for s in st.values()) == 200
    assert _db_state(str(tmp_path / "windflow_tpu")) == \
        _db_state(str(tmp_path / "windflow_tpu_torch"))


@pytest.mark.parametrize("first,second", [(wf, wt), (wt, wf)],
                         ids=["jax_then_port", "port_then_jax"])
def test_p_reduce_state_carries_across_packages(tmp_path, first, second):
    """A store the first package's P_Reduce kept reopens under the other
    package's P_Reduce, which goes on from it: its outputs and the final
    state equal two runs of one package, and one run over both halves."""
    mixed = str(tmp_path / "mixed")
    a = _p_reduce_run(first, mixed, start=0)
    b = _p_reduce_run(second, mixed, start=100)
    same = str(tmp_path / "same")
    a2 = _p_reduce_run(second, same, start=0)
    b2 = _p_reduce_run(second, same, start=100)
    assert a == a2 and b == b2
    assert _db_state(mixed) == _db_state(same)
    whole = str(tmp_path / "whole")
    _p_reduce_run(wt, whole, n=200)
    assert _db_state(mixed) == _db_state(whole)
    assert _db_state(mixed)[0] == {"n": 50,
                                   "sum": sum(range(0, 200, 4))}


def test_p_sink_eos_and_state(tmp_path):
    for pkg in (wf, wt):
        calls = {"eos": 0, "items": 0}

        def sink_fn(item, state):
            if item is None:
                calls["eos"] += 1
            else:
                calls["items"] += 1
                state["n"] = state.get("n", 0) + 1

        src = pkg.Source_Builder(lambda: iter(_stream(3, 30))).build()
        snk = (P(pkg).P_Sink_Builder(sink_fn).withName("psink")
               .withKeyBy(lambda t: t["key"]).withParallelism(2)
               .withDBPath(str(tmp_path / f"{pkg.__name__}_sink"))
               .withInitialState(dict).build())
        g = pkg.PipeGraph("p_sink", pkg.ExecutionMode.DEFAULT,
                          config=cfg(pkg))
        g.add_source(src).add_sink(snk)
        g.run()
        assert calls == {"items": 30, "eos": 2}, pkg.__name__


def test_persistent_builders_reject_what_jax_rejects():
    for pkg in (wf, wt):
        with pytest.raises(pkg.WindFlowError):
            P(pkg).P_Map_Builder(lambda t, s: t).withRebalancing()
        with pytest.raises(pkg.WindFlowError):
            P(pkg).P_Sink_Builder(lambda t, s: None).withOutputBatchSize(4)
        with pytest.raises(pkg.WindFlowError):
            P(pkg).P_Map_Builder(lambda t, s: t).withParallelism(2).build()


# ---------------------------------------------------------------------------
# persistent keyed windows
# ---------------------------------------------------------------------------

def _window_results(pkg, op_builder, length=300, n_keys=4, win=20,
                    slide=10):
    got = []

    def grab(r, ctx=None):
        if r is not None:
            got.append((r.key, r.wid, r.value))

    src = (pkg.Source_Builder(lambda: iter(_stream(n_keys, length)))
           .withName("src").build())
    win_op = (op_builder(lambda items: sum(t["value"] for t in items))
              .withName("win").withCBWindows(win, slide)
              .withKeyBy(lambda t: t["key"]).withParallelism(2).build())
    g = pkg.PipeGraph("pwin", pkg.ExecutionMode.DEFAULT, config=cfg(pkg))
    g.add_source(src).add(win_op).add_sink(
        pkg.Sink_Builder(grab).withName("sink").build())
    g.run()
    return sorted(got), win_op


def test_p_keyed_windows_match_in_memory(tmp_path):
    """Spilling windows (a tiny in-memory buffer forces fragments) give
    exactly the in-memory Keyed_Windows records, in both packages."""
    results = {}
    for pkg in (wf, wt):
        expected, _ = _window_results(pkg, pkg.Keyed_Windows_Builder)
        actual, op = _window_results(
            pkg, lambda fn: (P(pkg).P_Keyed_Windows_Builder(fn)
                             .withDBPath(str(tmp_path /
                                             f"{pkg.__name__}_win"))
                             .withMaxInMemoryElements(8)))
        assert actual == expected and len(actual) > 0
        results[pkg] = actual
        assert type(op).__name__ == "PKeyedWindows"
        assert op.checkpoint_opaque
    assert results[wt] == results[wf]


def test_p_keyed_windows_spill_every_key(tmp_path):
    """Every key's archive spills at least once (a buffer of 8 against 75
    tuples a key), and the engine reloads the fragments to fire."""
    spilled = {}
    seen = []

    class Spy(tp.SpillingArchive):
        def __init__(self, db, key, n_max):
            super().__init__(db, key, n_max)
            seen.append(self)

        def insert(self, entry):
            before = self.spilled_fragments
            super().insert(entry)
            if self.spilled_fragments > before:
                spilled[self._key] = spilled.get(self._key, 0) + 1

    import windflow_tpu_torch.persistent.p_windows as pw
    orig = pw.SpillingArchive
    pw.SpillingArchive = Spy
    try:
        got, _ = _window_results(
            wt, lambda fn: (tp.P_Keyed_Windows_Builder(fn)
                            .withDBPath(str(tmp_path / "spy"))
                            .withMaxInMemoryElements(8)))
    finally:
        pw.SpillingArchive = orig
    assert len(seen) == 4 and sorted(spilled) == [0, 1, 2, 3]
    expected, _ = _window_results(wt, wt.Keyed_Windows_Builder)
    assert got == expected
