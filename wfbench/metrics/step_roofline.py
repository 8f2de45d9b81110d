"""The whole step's share of its memory roofline, in percent: the least
bytes a batch's step must move (the configuration's ``least_bytes``:
each input lane it reads once, the state it touches read and written
once, its outputs written once), at the card's published bandwidth,
over the measured device time a batch (``device_ms_per_batch``)."""

import json
import os

from wfbench.metrics import device_ms_per_batch

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def read(run):
    ms = device_ms_per_batch.read(run)
    with open(PEAKS) as f:
        peak = json.load(f).get(run.kind)
    if not ms or not peak:
        return None
    least_s = run.module.least_bytes(run) / peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (ms / 1e3)
