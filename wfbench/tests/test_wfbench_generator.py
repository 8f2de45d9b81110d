"""The generator: determinism from the seed, and the replay's event
time."""

import numpy as np

from wfbench import generator

RECORD = {"key": "k", "key_range": 1000,
          "values": [{"name": "a", "range": 3},
                     {"name": "b", "range": 2 ** 53}]}
TRAFFIC = {"pool_records": 1000, "event_rate_per_s": 100_000,
           "hot_keys": 4, "hot_share": 0.25, "chunk_bytes": 32 * 7}


def test_same_seed_same_log_other_seed_other_log():
    big = 2 ** 40 + 7               # seeds beyond 32 bits
    a = generator.draw_pool(RECORD, TRAFFIC, np.random.default_rng(big))
    b = generator.draw_pool(RECORD, TRAFFIC, np.random.default_rng(big))
    c = generator.draw_pool(RECORD, TRAFFIC, np.random.default_rng(big + 1))
    assert a.tobytes() == b.tobytes()
    assert a.tobytes() != c.tobytes()
    assert (a["v"][:, 1] < 2 ** 53).all() and (a["v"][:, 1] % 1 == 0).all()


def test_hot_keys_carry_their_share():
    t = dict(TRAFFIC, pool_records=200_000)
    pool = generator.draw_pool(RECORD, t, np.random.default_rng(3))
    counts = np.bincount(pool["key"], minlength=1000)
    top = np.sort(counts)[-4:].sum() / len(pool)
    assert 0.24 < top < 0.27         # 25% hot, plus their uniform draws


def test_replay_advances_event_time_in_place():
    pool = generator.draw_pool(RECORD, TRAFFIC, np.random.default_rng(5))
    keys = pool["key"].copy()
    s = generator.ChunkStream(pool, TRAFFIC, warmup_records=400 * 7,
                              seconds=60.0)
    assert s.chunk_records == 7 and s.chunks_per_pass == 143
    got = []
    for k, chunk in enumerate(s()):
        rec = np.frombuffer(bytes(chunk), pool.dtype)
        got.append(rec)
        if k == 2 * 143 + 5:
            break
    rec = np.concatenate(got)
    n = len(rec)
    assert n == s.records_before(2 * 143 + 6) == s.records
    # stream record i carries ts = i * gap, its log record's key
    assert (rec["ts"] == np.arange(n) * 10).all()
    assert (rec["key"] == np.resize(keys, n)).all()
    # each record's chunk as the generator handed it over
    sizes = [len(g) for g in got]
    want = np.repeat(np.arange(len(got)), sizes)
    assert (s.chunk_of(np.arange(n)) == want).all()
    assert (np.diff(s.handed[:s.chunks]) >= 0).all()


def test_window_starts_after_warmup_and_ends_on_time():
    pool = generator.draw_pool(RECORD, TRAFFIC, np.random.default_rng(5))
    s = generator.ChunkStream(pool, TRAFFIC, warmup_records=3 * 7 - 6,
                              seconds=0.0)
    assert len(list(s())) == 4       # warm-up and the window's first
    assert s.stop_at == 4 and s.t_start == s.handed[3]
    assert s.window_records == s.records - 3 * 7
