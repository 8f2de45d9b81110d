"""FraudDetection: per-card Markov-chain transaction scoring (the DSPBench
application the JAX package ships as ``windflow_tpu/models/
fraud_detection.py``), on the port.

``Source(transactions) → stateful MapGPU (transition score) →
FilterGPU (low probability) → Sink``: each card's previous transaction
type is keyed device state (a dense slot table, ``withDenseKeys``), and
a transaction's score is the Markov transition probability from the
previous type, looked up in a table on the graph's device.  Transactions
scoring below ``threshold`` are flagged.  A card's first transaction
scores 1.0 (no prior, never flagged): the initial state is -1.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.basic import resolve_device


def scoring_ops(transition: Sequence[Sequence[float]], device, *,
                max_cards: int = 256, threshold: float = 0.05,
                dense: bool = True, card: str = "card",
                etype: str = "etype"):
    """The two device operators of the application: the stateful scorer,
    keyed by the record's ``card`` field, and the flag filter.  ``dense``
    declares the card ids slots in ``[0, max_cards)`` (no interning);
    otherwise arbitrary int32 ids are interned, or compacted when the
    scorer is fed from the host.  The output records are ``{"card",
    "etype", "score"}``."""
    table = torch.from_numpy(np.asarray(transition, np.float32)).to(device)

    def score(t, prev):
        e = t[etype]
        # prev < 0: the card's first transaction — no prior, score 1.0
        p = torch.where(prev < 0, 1.0,
                        table[prev.clamp(min=0).long(), e.long()])
        out = {"card": t[card], "etype": e, "score": p}
        return out, e.to(torch.int32)

    b = (wt.MapGPU_Builder(score).withName("markov_score")
         .withInitialState(torch.full((), -1, dtype=torch.int32))
         .withKeyBy(lambda t: t[card]).withNumKeySlots(max_cards))
    scorer = (b.withDenseKeys() if dense else b).build()
    flag = (wt.FilterGPU_Builder(lambda t: t["score"] < threshold)
            .withName("flag").build())
    return scorer, flag


def build(transactions: Iterable[dict],
          transition: Sequence[Sequence[float]],
          on_alert: Optional[Callable] = None, *, max_cards: int = 256,
          threshold: float = 0.05, batch: int = 1024,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """Transactions are dicts ``{"card": int, "etype": int}`` with
    ``etype`` in ``[0, len(transition))``; ``transition[i][j]`` is the
    probability of type ``j`` following type ``i``.  The graph runs on
    ``config.device`` (the card by default)."""
    config = config or wt.Config()

    def emit(res, ctx=None):
        if res is not None and on_alert is not None:
            on_alert({"card": int(res["card"]),
                      "etype": int(res["etype"]),
                      "score": float(res["score"])})

    scorer, flag = scoring_ops(transition, resolve_device(config),
                               max_cards=max_cards, threshold=threshold)
    src = (wt.Source_Builder(lambda: iter(transactions))
           .withName("transactions").withOutputBatchSize(batch).build())
    g = wt.PipeGraph("fraud_detection", wt.ExecutionMode.DEFAULT,
                     config=config)
    pipe = g.add_source(src)
    pipe.add(scorer)
    pipe.chain(flag)
    pipe.add_sink(wt.Sink_Builder(emit).withName("alerts").build())
    return g


def run(transactions: Iterable[dict],
        transition: Sequence[Sequence[float]], **kwargs) -> List[dict]:
    """Run to completion; returns the flagged ``{"card", "etype",
    "score"}`` alerts."""
    alerts: List[dict] = []
    build(transactions, transition, on_alert=alerts.append,
          **kwargs).run()
    return alerts
