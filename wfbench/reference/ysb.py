"""YSB's counts worked out again in plain numpy from the generated log.

Stream record ``i`` is log record ``i % n`` with ``ts = i * gap``.  Its
campaign is ``campaign_of_ad[ad]``; a view counts once in window ``ts //
window``.  A log replay spans a whole number of windows, so every replay
of the log holds the same counts, shifted by the windows it spans; the
last, partial replay holds the counts of its prefix (its open windows
are emitted at end of stream).  Counts are exact: the limit is 0."""

from __future__ import annotations

import numpy as np


def _windows(cfg, tables, keys, values, gap):
    """Per view of ``keys``/``values``: its code ``campaign * per + wid``
    (``per``: windows a replay spans) and its index."""
    n = len(keys)
    win = cfg["window_usec"]
    per, rem = divmod(n * gap, win)
    if rem:
        raise ValueError("a log replay must span whole windows")
    view = values[:, 0] == cfg["view_type"]
    idx = np.flatnonzero(view)
    camp = tables["campaign_of_ad"][keys[idx]].astype(np.int64)
    wid = idx.astype(np.int64) * gap // win
    return camp * per + wid, idx, per


def counts(cfg, tables, keys, values, gap, total):
    """Every window's ``(campaign, wid, count, last)`` over the first
    ``total`` stream records, ``last`` the stream index of its last view,
    sorted by ``(campaign, wid)``."""
    n = len(keys)
    code, idx, per = _windows(cfg, tables, keys, values, gap)
    size = cfg["campaigns"] * per
    passes, m = divmod(int(total), n)
    out = []
    for part, reps in ((n, range(passes)), (m, [passes] if m else [])):
        k = np.searchsorted(idx, part)
        c, j = code[:k], idx[:k]
        cnt = np.bincount(c, minlength=size)
        last = np.full(size, -1, np.int64)
        np.maximum.at(last, c, j)
        live = np.flatnonzero(cnt)
        for p in reps:
            out.append((live // per, p * per + live % per, cnt[live],
                        p * n + last[live]))
    if not out:
        e = np.zeros(0, np.int64)
        return e, e, e, e
    camp, wid, cnt, last = (np.concatenate(a) for a in zip(*out))
    order = np.lexsort((wid, camp))
    return camp[order], wid[order], cnt[order], last[order]


def check(cfg, tables, keys, values, gap, total, got):
    """``got``: the run's ``(campaign, wid, count)``, or None.  Returns
    the numbers compared, ``{name: (value, limit)}``, per got result the
    stream index of its last view (-1 where no such window is due), and
    the number of windows due."""
    camp, wid, cnt, last = counts(cfg, tables, keys, values, gap, total)
    if got is None:                 # no result reached the sink
        got = (np.zeros(0, np.int64),) * 3
    g_camp, g_wid, g_cnt = (np.asarray(a, np.int64) for a in got)
    span = int(max(wid.max(initial=0), g_wid.max(initial=0))) + 1
    want_code = camp * span + wid
    got_code = g_camp * span + g_wid
    hit = np.zeros(len(got_code), bool)
    pos = np.zeros(len(got_code), np.int64)
    if len(want_code):
        pos = np.minimum(np.searchsorted(want_code, got_code),
                         len(want_code) - 1)
        hit = want_code[pos] == got_code
    # each due window matched once, with its count
    matched = len(np.unique(got_code[hit & (cnt[pos] == g_cnt)])) \
        if len(want_code) else 0
    bad = (len(want_code) - matched) + (len(got_code) - matched)
    index = np.where(hit, last[pos], -1) if len(want_code) \
        else np.full(len(got_code), -1)
    return {"results_mismatched": (int(bad), 0)}, index, len(want_code)


def control(cfg, tables, keys, values, gap, total):
    """The control: this reference in the program's place with its count
    lane in bfloat16, the combiner's ``a + b`` adding one view at a time
    (8 significant bits: a count stops at 256, where 256 + 1 rounds back
    to 256).  It breaks the stated guarantee of exact counts."""
    camp, wid, cnt, _ = counts(cfg, tables, keys, values, gap, total)
    return camp, wid, np.minimum(cnt, 256)
