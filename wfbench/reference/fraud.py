"""DSPBench FraudDetection's outliers worked out again in plain numpy
from the generated log, in float64.

Stream record ``i`` is log record ``j = i % n`` of replay ``p = i // n``
with ``ts = i * gap``.  A card's transactions in the stream are its log
sequence repeated, so the window of its transaction at log position
``j`` is the cyclic window over that sequence: the ``window - 1`` states
before it (wrapping to the log's end) and its own.  The transaction is
scored once the card holds ``window`` states, when its appearance index
in the stream, ``p * c + r`` (``c`` the card's records a log, ``r`` this
one's rank among them), reaches ``window - 1``; it is an outlier when
its score exceeds ``threshold``.  Alerts are told apart by their stream
index (``ts / gap``).

The comparison: the sets of ``(card, index)`` alerts equal, each alert's
window of states equal, and each score within ``SCORE_TOL`` of the
float64 score.  Transactions whose float64 score lies within
``SCORE_TOL`` of the threshold are excused from set membership (counted
and printed).  Why 1e-6: the program holds the miss table in float32
(spacing 6e-8 near 1) and adds four of its entries in float32, so its
error is at most about 2e-7; a score in float16 (spacing 4.9e-4) or
bfloat16 (3.9e-3) misses it by hundreds of times and flips thousands of
alerts."""

from __future__ import annotations

import numpy as np

#: a score's largest distance from the float64 score, and the band
#: around the threshold excused from set membership
SCORE_TOL = 1e-6


def miss_table(transition) -> np.ndarray:
    """``miss[a, b] = sum_{j != b} P[a, j]``: each row's sum less the
    entry."""
    p = np.asarray(transition, np.float64)
    return p.sum(axis=1, keepdims=True) - p


def log_windows(cfg, tables, keys, values):
    """Per log position: the cyclic window ``[n, window]`` (int8, oldest
    first), the float64 score, the card's records a log ``c`` and this
    record's rank ``r`` among them."""
    n = len(keys)
    w = int(cfg["window"])
    state = values[:, 1].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.r_[True, sk[1:] != sk[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    runs = np.diff(np.r_[np.flatnonzero(first), n])
    count = np.repeat(runs, runs)
    rank = np.arange(n) - start
    s_state = state[order]
    win = np.empty((n, w), np.int8)
    for d in range(w):          # column w - 1 - d: d records back
        win[order, w - 1 - d] = s_state[start + (rank - d) % count]
    miss = miss_table(tables["transition"])
    score = np.zeros(n)
    for i in range(1, w):
        score += miss[win[:, i - 1], win[:, i]]
    score /= w - 1
    c = np.empty(n, np.int64)
    r = np.empty(n, np.int64)
    c[order], r[order] = count, rank
    return win, score, c, r


def _got_arrays(got, w):
    """``(card, ts, score, states [n, window])`` of the run's alerts,
    given as ``(card, ts, score, states)`` with the window's states
    packed in one integer a row (state ``k`` at bits ``5k``)."""
    if got is None:                 # no result reached the sink
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32), np.zeros((0, w), np.int64)
    card, ts, score, packed = (np.asarray(a) for a in got)
    states = (packed.astype(np.int64)[:, None]
              >> (5 * np.arange(w))) & 31
    return (card.astype(np.int64), ts.astype(np.int64),
            score.astype(np.float64), states)


def pack_states(win) -> np.ndarray:
    """``[n, window]`` states as one integer a row (state ``k`` at bits
    ``5k``), the run's alert format."""
    win = np.asarray(win, np.int64)
    return (win << (5 * np.arange(win.shape[1]))).sum(1)


def check(cfg, tables, keys, values, gap, total, got):
    """``got``: the run's ``(card, ts, score, states)`` (the window's
    states packed, :func:`pack_states`), or None.  Returns
    the numbers compared, ``{name: (value, limit)}``, per got alert its
    stream index (-1 where no such alert is due), and the number of
    alerts due.  Computed a log replay at a time."""
    n, w = len(keys), int(cfg["window"])
    thr = float(cfg["threshold"])
    win, score, c, r = log_windows(cfg, tables, keys, values)
    g_card, g_ts, g_score, g_states = _got_arrays(got, w)
    g_idx = g_ts // gap
    bad = int(np.count_nonzero(g_ts % gap))
    bad += int(np.count_nonzero((g_idx < 0) | (g_idx >= int(total))))
    over = score > thr
    border = np.abs(score - thr) <= SCORE_TOL
    want_all = over & ~border
    passes, m = divmod(int(total), n)
    sort = np.argsort(g_idx, kind="stable")
    s_idx = g_idx[sort]
    index = np.full(len(g_idx), -1, np.int64)
    due = excused = 0
    err = 0.0
    for p in range(passes + (1 if m else 0)):
        part = n if p < passes else m
        lo, hi = np.searchsorted(s_idx, [p * n, p * n + part])
        at = sort[lo:hi]
        j = g_idx[at] - p * n
        # from replay window - 1 on, every card holds a full window
        scored = p * c[:part] + r[:part] >= w - 1 if p < w - 1 else None
        want = want_all[:part] if scored is None \
            else scored & want_all[:part]
        ok_j = np.ones(len(j), bool) if scored is None else scored[j]
        seen = np.bincount(j, minlength=part)
        # every alert once, each on a scored transaction with its card,
        # window and score
        bad += int(np.count_nonzero(seen > 1))
        bad += int(np.count_nonzero(want & (seen == 0)))
        bad += int(np.count_nonzero(~ok_j))
        bad += int(np.count_nonzero(ok_j & ~over[j] & ~border[j]))
        bad += int(np.count_nonzero(g_card[at] != keys[j]))
        bad += int(np.count_nonzero((g_states[at] != win[j]).any(1)))
        if len(j):
            err = max(err, float(np.abs(g_score[at] - score[j])[ok_j].max(
                initial=0.0)))
        index[at] = np.where(ok_j & (over[j] | border[j]), p * n + j, -1)
        if scored is None:
            due += int(np.count_nonzero(over[:part]))
            excused += int(np.count_nonzero(border[:part]))
        else:
            due += int(np.count_nonzero(scored & over[:part]))
            excused += int(np.count_nonzero(scored & border[:part]))
    # printed on standard error (file descriptor 2: the reference
    # imports numpy alone), beside the run's checks
    with open(2, "w", closefd=False) as stderr:
        stderr.write(f"fraud: {excused} scored transactions within "
                  f"{SCORE_TOL} of the threshold, excused from set "
                  "membership\n")
    return ({"alerts_mismatched": (bad, 0),
             "score_abs_err_max": (err, SCORE_TOL)}, index, due)


def control(cfg, tables, keys, values, gap, total, dtype="bfloat16"):
    """The control: this reference in the program's place with its score
    rounded to ``dtype`` (bfloat16 or float16) before the threshold.  It
    breaks the stated precision of the score."""
    n, w = len(keys), int(cfg["window"])
    win, score, c, r = log_windows(cfg, tables, keys, values)
    low = _round(score, dtype)
    out = []
    passes, m = divmod(int(total), n)
    for p in range(passes + (1 if m else 0)):
        part = n if p < passes else m
        j = np.flatnonzero((p * c[:part] + r[:part] >= w - 1)
                           & (low[:part] > cfg["threshold"]))
        out.append(p * n + j)
    idx = np.concatenate(out) if out else np.zeros(0, np.int64)
    j = idx % n
    return (keys[j], idx * gap, low[j].astype(np.float32),
            pack_states(win[j]))


def _round(x, dtype):
    """``x`` rounded to ``dtype`` (to nearest, ties to even), as float64."""
    if dtype == "float16":
        return x.astype(np.float16).astype(np.float64)
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32).astype(np.float64)
