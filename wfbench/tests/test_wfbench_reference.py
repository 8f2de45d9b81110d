"""The references against hand-worked tiny streams."""

import numpy as np

from wfbench.reference import ysb

YSB = {"campaigns": 2, "ads_per_campaign": 2, "view_type": 0,
       "window_usec": 30}
YSB_TABLES = {"campaign_of_ad": np.array([0, 1, 1, 0], np.int32)}
# ads and event types of a 6-record log, 10 µs apart: two windows a
# replay; views at 0, 1, 3, 4
YSB_KEYS = np.array([0, 1, 2, 3, 0, 1])
YSB_VALUES = np.array([[0], [0], [1], [0], [0], [2]], np.float64)


def test_ysb_counts_by_hand():
    # 9 records: one replay and 3 of the next (ts 60-80, window 2)
    camp, wid, cnt, last = ysb.counts(YSB, YSB_TABLES, YSB_KEYS, YSB_VALUES,
                                      10, 9)
    assert camp.tolist() == [0, 0, 0, 1, 1]
    assert wid.tolist() == [0, 1, 2, 0, 2]
    assert cnt.tolist() == [1, 2, 1, 1, 1]
    assert last.tolist() == [0, 4, 6, 1, 7]


def test_ysb_check_counts_each_fault():
    want = (np.array([0, 0, 0, 1, 1]), np.array([0, 1, 2, 0, 2]),
            np.array([1, 2, 1, 1, 1]))

    def bad(got):
        return ysb.check(YSB, YSB_TABLES, YSB_KEYS, YSB_VALUES, 10, 9,
                         got)[0]["results_mismatched"][0]
    assert bad(want) == 0
    assert bad(tuple(a[::-1] for a in want)) == 0      # order is free
    assert bad(tuple(a[1:] for a in want)) == 1        # one missing
    assert bad(tuple(np.r_[a, a[:1]] for a in want)) == 1   # repeated
    wrong = (want[0], want[1], want[2] + np.array([0, 0, 0, 0, 1]))
    assert bad(wrong) == 2                              # wrong count
    assert bad(None) == 5
    _, index, due = ysb.check(YSB, YSB_TABLES, YSB_KEYS, YSB_VALUES, 10, 9,
                              want)
    assert index.tolist() == [0, 4, 6, 1, 7] and due == 5


def test_ysb_control_breaks_exact_counts():
    keys = np.zeros(3000, np.int64)
    values = np.zeros((3000, 1))
    cfg = dict(YSB, window_usec=30000)
    got = ysb.control(cfg, YSB_TABLES, keys, values, 10, 3000)
    assert got[2].tolist() == [256]
    assert ysb.check(cfg, YSB_TABLES, keys, values, 10, 3000,
                     got)[0]["results_mismatched"][0] == 2

