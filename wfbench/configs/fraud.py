"""DSPBench FraudDetection on the port (``build_dspbench`` of the port's
``models/fraud_detection.py``, fed by frames): FrameSource (EVENT time)
→ the Markov-model predictor, a stateful MapGPU keyed by the card with
dense keys (per card its last four states and a count, one word; the
wavefront applies each card's transactions in arrival order, a CUDA
graph WHILE node on the card) → the outlier filter (``score >
threshold``) → columnar Sink.  The source declares no record spec, so
the wire plane stays off."""

from __future__ import annotations

import numpy as np


def draw(cfg: dict, rng) -> dict:
    """The seeded Markov model: each row Dirichlet(``dirichlet_alpha``)
    over the ``states`` states, float64."""
    k = int(cfg["states"])
    return {"transition": rng.dirichlet(np.full(k, cfg["dirichlet_alpha"]),
                                        size=k)}


def build(cfg: dict, tables: dict, chunks, sink_fn, config):
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.models.fraud_detection import build_dspbench
    fields = [f["name"] for f in cfg["record"]["values"]]
    src = wt.FrameSource(chunks, nv=len(fields), fields=fields,
                         name="transactions",
                         output_batch_size=cfg["batch"])
    return build_dspbench(src, tables["transition"], sink_fn,
                          cards=cfg["record"]["key_range"],
                          window=cfg["window"], threshold=cfg["threshold"],
                          config=config)


def collect(cols, tss) -> tuple:
    """One sink delivery as ``(card, ts, score, states)``: copies (the
    delivery's arrays may view its whole egress buffer) in the program's
    dtypes, the window's states (codes below 32) packed in one int64 a
    row (state ``k`` at bits ``5k``, the newest highest) so that a run
    keeps 24 bytes an alert; the comparison unpacks them after the
    window."""
    states = np.zeros(len(tss), np.int64)
    k = 0
    while f"s{k}" in cols:
        states |= np.asarray(cols[f"s{k}"], np.int64) << (5 * k)
        k += 1
    return (np.array(cols["card"]), np.array(tss),
            np.array(cols["score"]), states)


def least_bytes(run) -> float:
    """The least bytes one batch's step must move: each lane's card
    (int32) and state (float32) read once, each card the batch touches
    read and written once at its stored width (the state word), the miss
    table once, and each alert written once (card, score and the window's
    states as int32, ts int64).  The cards touched are counted on the
    log's first batches."""
    from windflow_tpu_torch.models.fraud_detection import state_word
    cfg, b = run.cfg, run.cfg["batch"]
    dtype = state_word(cfg["window"], cfg["states"])[0]
    width = 4 if str(dtype) == "torch.int32" else 8
    keys = run.pool["key"]
    slices = [keys[i:i + b] for i in range(0, min(len(keys), 8 * b), b)]
    touched = float(np.mean([len(np.unique(s)) for s in slices])) \
        * b / max(1, len(slices[0]))
    return (8 * b + 2 * width * touched + 4 * cfg["states"] ** 2
            + (16 + 4 * cfg["window"]) * run.results_per_batch)
