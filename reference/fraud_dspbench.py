"""DSPBench FraudDetection's predictor, transcribed literally: Beymani's
``MarkovModelPredictor`` under ``fd.detection.algorithm=missProbability``
(DSPBench, Bordin et al., IEEE Access 2020, github.com/GMAP/DSPBench).

Per entity (card) a list of its records' states, one event at a time:
the new state joins the list, the list is trimmed to the first
``window`` (``fd.state.seq.window.size``) by removing its head, and once
it holds ``window`` states the event is scored: for each transition
``i = 1 .. window - 1`` the probability of every state ``j`` other than
the one that came, ``sum_{j != s_i} P[s_{i-1}, j]``, averaged over the
transitions.  A score above ``threshold`` (``fd.metric.threshold``) is
an outlier.  Plain PyTorch, float64, on the CPU; no kernel of the port.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch


def predict(events: Iterable[Tuple[int, int]], transition, *,
            window: int = 5, threshold: float = 0.96) -> List[dict]:
    """Every scored event of ``events`` (``(card, state)`` in arrival
    order) as ``{"index", "card", "score", "states", "outlier"}``:
    ``index`` its position in ``events``, ``states`` the window, oldest
    first."""
    probs = torch.as_tensor(transition, dtype=torch.float64)
    num_states = probs.shape[0]
    records = {}
    scored = []
    for index, (card, state) in enumerate(events):
        seq = records.setdefault(int(card), [])
        seq.append(int(state))
        if len(seq) > window:
            seq.pop(0)
        if len(seq) < window:
            continue
        total = torch.zeros((), dtype=torch.float64)
        for i in range(1, window):
            pr, cu = seq[i - 1], seq[i]
            prob = torch.zeros((), dtype=torch.float64)
            for j in range(num_states):
                if j != cu:
                    prob = prob + probs[pr, j]
            total = total + prob
        score = float(total / (window - 1))
        scored.append({"index": index, "card": int(card), "score": score,
                       "states": tuple(seq), "outlier": score > threshold})
    return scored
