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

DSPBench's own predictor (Bordin et al., IEEE Access 2020; Beymani's
``MarkovModelPredictor`` under ``fd.detection.algorithm=missProbability``)
is :func:`dspbench_ops` / :func:`build_dspbench`: per card the last
``window`` states (``fd.state.seq.window.size``, 5), the newest joining
before the score; a card is scored once it holds ``window`` states, as

    score = 1/(window-1) * sum_{i=1..window-1} sum_{j != s_i} P[s_{i-1}, j]

and an outlier is ``score > threshold`` (``fd.metric.threshold``, 0.96),
emitted with its card, its score and the window's states.  The inner sum
is ``rowsum(s_{i-1}) - P[s_{i-1}, s_i]``, exact for any matrix: the
``[states, states]`` miss table is built once in float64 and held on the
device in float32.
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


#: DSPBench FraudDetection's settings: ``fd.state.seq.window.size``,
#: ``fd.metric.threshold``, and Beymani's 18 transaction states (amount
#: level 3 x high-price item 2 x time since the last transaction 3)
DSPBENCH_WINDOW, DSPBENCH_THRESHOLD, DSPBENCH_STATES = 5, 0.96, 18


def miss_table(transition) -> np.ndarray:
    """``miss[a, b] = sum_{j != b} P[a, j]``, in float64: each row's sum
    less the entry (the identity holds for any matrix)."""
    p = np.asarray(transition, np.float64)
    return p.sum(axis=1, keepdims=True) - p


def state_word(window: int, states: int):
    """The packing of a card's state in one integer word: ``(dtype,
    state bits, count bits)``.  The low ``count bits`` hold how many
    states the card holds before its next transaction (saturating at
    ``window - 1``); above them, ``state bits`` a state, the newest
    lowest."""
    held = window - 1
    if held < 1 or states < 1:
        raise ValueError("window must be at least 2 and states at least 1")
    sbits = max(1, (states - 1).bit_length())
    cbits = held.bit_length()
    need = held * sbits + cbits
    if need > 63:
        raise ValueError(f"a window of {window} over {states} states needs "
                         f"{need} bits of state a card (at most 63)")
    return (torch.int32 if need <= 31 else torch.int64), sbits, cbits


def dspbench_ops(transition: Sequence[Sequence[float]], device, *,
                 cards: int, window: int = DSPBENCH_WINDOW,
                 threshold: float = DSPBENCH_THRESHOLD):
    """DSPBench's predictor as two device operators: the stateful scorer,
    keyed by the record's ``key``, a dense card id in ``[0, cards)`` (no
    interning), and the outlier filter ``score > threshold``.
    ``transition`` is the ``[states, states]`` Markov model; a record's
    ``state`` field is its state code.  The output records are
    ``{"card", "score", "s0", ..., "s<window - 1>"}`` (the window's
    states, oldest first; int32); a transaction that is not scored (its
    card holds fewer than ``window`` states) scores -inf."""
    states = len(transition)
    dtype, sbits, cbits = state_word(window, states)
    held = window - 1
    miss = torch.from_numpy(miss_table(transition).astype(np.float32)
                            .reshape(-1)).to(device)
    smask, cmask = (1 << sbits) - 1, (1 << cbits) - 1
    hmask = (1 << (held * sbits)) - 1

    def score(t, word):
        cur = t["state"].to(torch.int64)
        w = word.to(torch.int64)
        n = w & cmask
        hist = w >> cbits
        seq = [(hist >> ((held - 1 - k) * sbits)) & smask
               for k in range(held)] + [cur]
        total = miss[seq[0] * states + seq[1]]
        for i in range(2, window):
            total = total + miss[seq[i - 1] * states + seq[i]]
        p = torch.where(n == held, total / held, float("-inf"))
        new = ((((hist << sbits) | cur) & hmask) << cbits) \
            | torch.clamp(n + 1, max=held)
        out = {"card": t["key"], "score": p}
        for k, sk in enumerate(seq):
            out[f"s{k}"] = sk.to(torch.int32)
        return out, new.to(dtype)

    scorer = (wt.MapGPU_Builder(score).withName("markov_predictor")
              .withInitialState(torch.zeros((), dtype=dtype))
              .withKeyBy(lambda t: t["key"]).withNumKeySlots(cards)
              .withDenseKeys().build())
    flag = (wt.FilterGPU_Builder(lambda t: t["score"] > threshold)
            .withName("outlier").build())
    return scorer, flag


def build_dspbench(source, transition: Sequence[Sequence[float]],
                   sink_fn: Callable, *, cards: int,
                   window: int = DSPBENCH_WINDOW,
                   threshold: float = DSPBENCH_THRESHOLD,
                   config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """DSPBench FraudDetection's topology on the port, in event time:
    ``source`` (a built source operator whose records carry the card as
    ``key`` and a ``state``, as ``FrameSource`` with ``fields=[...,
    "state"]``) → the predictor (fields grouping on the card: the
    dense-keyed stateful scorer) → the outlier filter → a columnar sink,
    ``sink_fn(columns)`` receiving each alert's fields and ``ts``.  The
    graph runs on ``config.device`` (the card by default)."""
    config = config or wt.Config()
    scorer, flag = dspbench_ops(transition, resolve_device(config),
                                cards=cards, window=window,
                                threshold=threshold)
    g = wt.PipeGraph("fraud_dspbench", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=config)
    pipe = g.add_source(source)
    pipe.add(scorer)
    pipe.chain(flag)
    pipe.add_sink(wt.Sink_Builder(sink_fn).withName("alerts")
                  .withColumnarSink().build())
    return g
