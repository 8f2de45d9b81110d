"""``fraud.uniform`` at a test size on the CPU: the run is correct on
three seeds, and the comparison fails what it must (the control, a
state left unchanged, a score in bfloat16)."""

import json

import pytest
import torch

import windflow_tpu_torch as wt
from wfbench import control
from wfbench.tests.test_wfbench_run import ROOT, run_line

CELL = "fraud.uniform"
#: the cell's shapes at a CPU's scale: 3,000 cards, 60,000 records a log
SMALL = {"cfg_override": {
    "batch": 4096, "warmup_batches": 4,
    "record": {"key": "card", "key_range": 3000, "values": [
        {"name": "transaction_id", "range": 2 ** 53},
        {"name": "state", "range": 18}]}},
    "traffic_override": {"pool_records": 60000, "chunk_bytes": 65536}}
SEEDS = [1, 2 ** 35 + 3, 77]


@pytest.mark.parametrize("seed", SEEDS)
def test_fraud_run_is_correct(seed):
    rc, out, _ = run_line(CELL, seed=seed, **SMALL)
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_fraud_control_comes_out_not_correct(seed):
    checks = control.control_checks(ROOT, CELL, seed, 300_000, **SMALL)
    assert any(v > lim for v, lim in checks.values())


def _wrap_scorer(monkeypatch, wrap):
    """The predictor's function replaced by ``wrap(fn)``."""
    orig = wt.MapGPU_Builder
    monkeypatch.setattr(wt, "MapGPU_Builder",
                        lambda fn, *a, **k: orig(wrap(fn), *a, **k))


def state_unchanged(monkeypatch):
    """The predictor returns each card's state unchanged."""
    _wrap_scorer(monkeypatch, lambda fn: lambda t, s: (fn(t, s)[0], s))


def bfloat16_score(monkeypatch):
    """The predictor's score rounded to bfloat16."""
    def wrap(fn):
        def low(t, s):
            out, new = fn(t, s)
            out = dict(out, score=out["score"].to(torch.bfloat16).float())
            return out, new
        return low
    _wrap_scorer(monkeypatch, wrap)


@pytest.mark.parametrize("fault", [state_unchanged, bfloat16_score])
def test_a_broken_scorer_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rc, out, _ = run_line(CELL, **SMALL)
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is False and line["failed"] > 0
