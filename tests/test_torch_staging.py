"""The port's data plane (windflow_tpu_torch/batch.py, staging.py):
packed staging and packed egress round trips, on the CPU.

A staged round trip must be bit-identical for every packable lane dtype
(staging.packable_dtype), NaN payloads and -0.0 included, and must agree
with the JAX package's own round trip on the same numpy columns.
"""

import numpy as np
import pytest
import torch

import windflow_tpu  # noqa: F401  (the JAX package's process setup)
from windflow_tpu import batch as jbatch
from windflow_tpu_torch import batch as tbatch
from windflow_tpu_torch import staging
from windflow_tpu_torch.utils.tree import tree_flatten

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _adversarial_columns(n):
    rng = np.random.default_rng(n)
    f = rng.standard_normal(n).astype(np.float32)
    f[:4] = [np.float32("nan"), -0.0, np.inf, -np.inf]
    fbits = f.view(np.uint32)
    fbits[0] = 0x7FC01234          # a NaN with a payload
    return {
        "i32": rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
        .astype(np.int32),
        "u32": rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
        "f32": f,
        "i64": np.concatenate([[np.iinfo(np.int64).min,
                                np.iinfo(np.int64).max, -1, 0],
                               rng.integers(-2 ** 62, 2 ** 62, n - 4)])
        .astype(np.int64),
        "u64": rng.integers(0, 2 ** 63, n, dtype=np.uint64),
    }


@pytest.mark.parametrize("n,cap", [(64, 64), (37, 64), (5, 8)])
def test_packed_round_trip_bit_identical(n, cap):
    cols = _adversarial_columns(n)
    tss = np.arange(n, dtype=np.int64) * 3 - 7
    db = tbatch.columns_to_device(cols, tss, cap, CPU, watermark=5)
    assert db.known_size == n and db.capacity == cap
    assert db.valid.sum().item() == n
    back, btss = tbatch.device_to_columns(db)
    np.testing.assert_array_equal(btss, tss)
    for name, c in cols.items():
        assert back[name].dtype == c.dtype, name
        np.testing.assert_array_equal(back[name].view(np.uint8),
                                      c.view(np.uint8))
    # the JAX package's round trip of the same columns agrees
    jb = jbatch.columns_to_device({k: v for k, v in cols.items()
                                   if k != "u64"}, tss, cap)
    jcols, jtss = jbatch.device_to_columns(jb)
    np.testing.assert_array_equal(jtss, btss)
    for name in jcols:
        np.testing.assert_array_equal(np.asarray(jcols[name]).view(np.uint8),
                                      back[name].view(np.uint8))


def test_record_staging_packs_and_pads():
    items = [{"k": np.int32(i), "v": np.float32(i / 2)} for i in range(5)]
    hb = tbatch.HostBatch(items, list(range(100, 105)), watermark=3)
    db = tbatch.host_to_device(hb, 8, CPU, frontier=9)
    assert db.payload["k"].dtype == torch.int32
    assert db.payload["v"].dtype == torch.float32
    assert db.valid.tolist() == [True] * 5 + [False] * 3
    assert db.frontier == 9 and db.watermark == 3
    back = tbatch.device_to_host(db)
    assert back.items == [{"k": i, "v": i / 2} for i in range(5)]
    assert back.tss == list(range(100, 105))


def test_unpackable_lanes_take_the_per_lane_path():
    items = [{"x": np.float64(i) + 0.25, "b": np.int16(i)} for i in range(3)]
    db = tbatch.host_to_device(tbatch.HostBatch(items, [1, 2, 3]), 4, CPU)
    assert db.payload["x"].dtype == torch.float64
    back = tbatch.device_to_host(db)
    assert back.items == [{"x": i + 0.25, "b": i} for i in range(3)]


def test_staged_batch_does_not_alias_the_recycled_buffer():
    """On the CPU the copy is real, so reusing a pooled buffer cannot
    rewrite an earlier batch."""
    pool = staging.StagingPool(depth=2)
    b1 = staging.PackedBatchBuilder(("int32",), 4, pool=pool)
    b1.append([np.arange(4, dtype=np.int32)], np.zeros(4, np.int64))
    db1 = tbatch.stage_packed(b1.finish(), tree_flatten({"a": 0})[1],
                              ("int32",), 4, 4, CPU, pool=pool)
    b2 = staging.PackedBatchBuilder(("int32",), 4, pool=pool)
    b2.append([np.full(4, 9, np.int32)], np.zeros(4, np.int64))
    b2.finish()
    assert pool.hits == 1
    assert db1.payload["a"].tolist() == [0, 1, 2, 3]


def test_filtered_egress_selects_valid_lanes_only():
    db = tbatch.DeviceBatch({"a": torch.arange(6, dtype=torch.int32)},
                            torch.arange(6, dtype=torch.int64),
                            torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.bool))
    cols, tss = tbatch.device_to_columns(db)
    assert cols["a"].tolist() == [0, 2, 3] and tss.tolist() == [0, 2, 3]
    assert tbatch.transfer_nbytes(db) == 6 * 4 + 6 * 8 + 6


@pytest.mark.parametrize("valid", [[1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 0, 0]])
def test_egress_from_a_reused_buffer_owns_its_columns(valid):
    """Egress from a card lands in one page-locked buffer per thread that
    the next delivery overwrites: the unpacked columns are copies of it,
    on the slice route (a known all-valid prefix) and the gather route."""
    db = tbatch.DeviceBatch({"a": torch.arange(6, dtype=torch.int32) + 10,
                             "f": torch.arange(6, dtype=torch.float64)},
                            torch.arange(6, dtype=torch.int64) * 7,
                            torch.tensor(valid, dtype=torch.bool),
                            size=4 if valid[1] else None)
    leaves, treedef = tree_flatten(db.payload)
    raw = torch.cat([tbatch._to_words(l) for l in leaves]
                    + [tbatch._to_words(db.ts),
                       tbatch._to_words(db.valid)]).numpy().copy()
    specs = [np.dtype(np.float64) if l.dtype == torch.float64
             else np.dtype(np.int32) for l in leaves]
    cols, tss = tbatch._egress_unpack(raw, specs, treedef, 6,
                                      db.known_size, reused=True)
    want = np.flatnonzero(valid)
    for c in (*cols.values(), tss):
        assert not np.shares_memory(c, raw)
    raw[:] = -1                                  # the next delivery
    assert cols["a"].tolist() == (want + 10).tolist()
    assert cols["f"].tolist() == want.astype(float).tolist()
    assert tss.tolist() == (want * 7).tolist()
