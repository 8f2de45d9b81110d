"""Each cell run on the card as the benchmark runs it, for a short
window (``pytest -m cuda wfbench/tests`` on a machine with a card)."""

import json
import os
import subprocess
import sys

import pytest

from wfbench.tests._small import SMALL
from wfbench.tests.test_wfbench_run import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "wfbench/run.py", "--workload", cell,
                        "--seed", "4242", "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=1200, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
