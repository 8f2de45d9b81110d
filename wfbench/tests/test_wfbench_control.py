"""The comparison fails what it must: the control (the reference at a
lower precision in the program's place), and a run whose timed path is
broken underneath, once for each fault a cell can have (one card: no
exchange between chips to leave out)."""

import json

import numpy as np
import pytest

import windflow_tpu_torch as wt
from windflow_tpu_torch import batch as wt_batch
from windflow_tpu_torch import native
from wfbench import control
from wfbench.tests._small import SMALL, overrides
from wfbench.tests.test_wfbench_run import ROOT, run_line


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2 ** 35 + 3, 77])
def test_control_comes_out_not_correct(cell, seed):
    checks = control.control_checks(ROOT, cell, seed, 3_000_000,
                                    **overrides(cell))
    assert any(v > lim for v, lim in checks.values())


def state_unchanged(monkeypatch, cell):
    """The tail's step returns its state unchanged."""
    orig = wt.Ffat_WindowsGPU_Builder
    monkeypatch.setattr(wt, "Ffat_WindowsGPU_Builder",
                        lambda lift, comb: orig(lift, lambda a, b: a))


def half_batch(monkeypatch, cell):
    """Half of every chunk's records never reach the step."""
    orig = native.parse_frames

    def half(buf, nv):
        keys, tss, vals, used = orig(buf, nv)
        h = len(keys) // 2
        return keys[:h], tss[:h], vals[:h], used
    monkeypatch.setattr(native, "parse_frames", half)


def altered_answer(monkeypatch, cell):
    """One answer altered where it leaves the card."""
    orig = wt_batch.device_to_columns_multi
    done = []

    def alter(batches):
        out = orig(batches)
        for cols, tss in out:
            if len(tss) and not done:
                lane = sorted(cols)[-1]
                cols[lane] = np.array(cols[lane], copy=True)
                cols[lane][0] += 1
                done.append(lane)
        return out
    monkeypatch.setattr(wt_batch, "device_to_columns_multi", alter)


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_answer])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, cell,
                                                   fault):
    fault(monkeypatch, cell)
    rc, out, _ = run_line(cell)
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is False and line["failed"] > 0
