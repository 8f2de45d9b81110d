"""The port's embedded log store (windflow_tpu_torch/persistent/kv.py)
against the JAX package's (windflow_tpu/persistent/kv.py), on the CPU:
round trip and reopen, compaction (tests/test_persistent.py:25, :52),
torn-tail recovery at every byte offset and one-byte corruption at every
offset against the JAX ``_PyKV``'s recovery points (:118, :165), a store
written by either package opened by the other, and the shared-store
registry.  The durability plane's commit protocol rests on the torn-tail
rule: an epoch exists iff its manifest record survives recovery.

Tolerance: exact (bytes)."""

import pytest

from windflow_tpu.persistent.kv import _PyKV as JPyKV
from windflow_tpu.persistent.kv import LogKV as JLogKV
from windflow_tpu_torch.persistent import kv as tkv
from windflow_tpu_torch.persistent.kv import LogKV


def test_kv_roundtrip_and_reopen(tmp_path):
    path = str(tmp_path / "store")
    kv = LogKV(path)
    kv.put(b"a", b"1")
    kv.put(b"b", b"x" * 10_000)
    kv.put(b"a", b"2")
    assert kv.delete(b"missing") is False
    assert kv.get(b"a") == b"2" and kv.get(b"b") == b"x" * 10_000
    assert kv.get(b"nope") is None and len(kv) == 2
    kv.put(b"c", b"3")
    kv.delete(b"b")
    assert sorted(kv.keys()) == [b"a", b"c"]
    kv.flush()
    kv.close()
    kv2 = LogKV(path)
    assert (kv2.get(b"a"), kv2.get(b"b"), kv2.get(b"c")) == \
        (b"2", None, b"3")
    kv2.close(delete_db=True)
    kv3 = LogKV(path)
    assert len(kv3) == 0
    kv3.close(delete_db=True)


def test_kv_compaction_reclaims_space(tmp_path):
    kv = LogKV(str(tmp_path / "store"))
    for i in range(200):
        kv.put(b"hot", b"v%d" % i)
    before = kv.log_bytes()
    kv.compact()
    assert kv.log_bytes() < before
    assert kv.get(b"hot") == b"v199" and len(kv) == 1
    assert kv.live_bytes() == kv.log_bytes()
    kv.close(delete_db=True)


def test_kv_auto_compacts_past_the_ratio(tmp_path):
    kv = LogKV(str(tmp_path / "store"), compact_ratio=2.0,
               min_compact_bytes=1024)
    for i in range(400):
        kv.put(b"k", b"%06d" % i)
    assert kv.log_bytes() <= 2.0 * kv.live_bytes() + 1024
    assert kv.get(b"k") == b"000399"
    kv.close(delete_db=True)


def _written_image(tmp_path, kv_cls, name):
    path = str(tmp_path / name)
    kv = kv_cls(path)
    kv.put(b"a", b"1")
    kv.put(b"bb", b"x" * 37)
    kv.put(b"a", b"2")
    kv.delete(b"bb")
    kv.put(b"ccc", bytes(range(64)))
    kv.put(b"d" * 9, b"")
    kv.flush()
    raw = open(path, "rb").read()
    kv.close(delete_db=True)
    return raw


def _recover(tmp_path, kv_cls, raw, tag):
    """Open a byte image (a private copy: recovery truncates in place);
    return the live map and the recovered log length."""
    p = str(tmp_path / f"img_{tag}")
    with open(p, "wb") as f:
        f.write(raw)
    kv = kv_cls(p)
    out = ({k: kv.get(k) for k in kv.keys()}, kv.log_bytes())
    kv.close(delete_db=True)
    return out


def test_kv_writes_the_jax_bytes(tmp_path):
    """The same operations write the same log, byte for byte."""
    assert _written_image(tmp_path, tkv._PyKV, "t") == \
        _written_image(tmp_path, JPyKV, "j")


def test_kv_torn_tail_recovery_matches_jax_at_every_offset(tmp_path):
    raw = _written_image(tmp_path, tkv._PyKV, "ref")
    assert len(raw) < 400
    for cut in range(len(raw) + 1):
        got = _recover(tmp_path, tkv._PyKV, raw[:cut], f"t{cut}")
        want = _recover(tmp_path, JPyKV, raw[:cut], f"j{cut}")
        assert got == want, f"cut={cut}: {got} vs {want}"
        assert got[1] <= cut
    assert _recover(tmp_path, tkv._PyKV, raw, "full")[0] == {
        b"a": b"2", b"ccc": bytes(range(64)), b"d" * 9: b""}


def test_kv_corruption_recovery_matches_jax_at_every_offset(tmp_path):
    path = str(tmp_path / "ref")
    kv = tkv._PyKV(path)
    kv.put(b"k1", b"alpha")
    kv.put(b"k2", b"beta" * 8)
    kv.delete(b"k1")
    kv.put(b"k3", b"gamma")
    kv.flush()
    raw = bytearray(open(path, "rb").read())
    kv.close(delete_db=True)
    for off in range(len(raw)):
        bad = bytes(raw[:off]) + bytes([raw[off] ^ 0xFF]) \
            + bytes(raw[off + 1:])
        assert _recover(tmp_path, tkv._PyKV, bad, f"t{off}") == \
            _recover(tmp_path, JPyKV, bad, f"j{off}"), off


@pytest.mark.parametrize("writer,reader", [(LogKV, JLogKV),
                                           (JLogKV, LogKV)],
                         ids=["port_to_jax", "jax_to_port"])
def test_kv_store_opens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "store")
    kv = writer(path)
    kv.put(b"k1", b"v1")
    kv.put(b"k2", bytes(range(256)))
    kv.delete(b"k1")
    kv.flush()
    kv.close()
    other = reader(path)
    assert other.get(b"k1") is None
    assert other.get(b"k2") == bytes(range(256))
    other.put(b"k3", b"from_the_reader")
    other.close()
    back = writer(path)
    assert back.get(b"k3") == b"from_the_reader"
    back.close(delete_db=True)


def test_open_shared_refcounts_one_handle(tmp_path):
    path = str(tmp_path / "shared")
    a = tkv.open_shared(path)
    b = tkv.open_shared(path)
    assert a is b
    a.put(b"x", b"1")
    tkv.close_shared(path)            # one reference left: still open
    assert b.get(b"x") == b"1"
    tkv.close_shared(path, delete_db=True)
    tkv.close_shared(path)            # unknown path: a no-op
    c = tkv.open_shared(path)
    assert c is not a and len(c) == 0
    tkv.close_shared(path, delete_db=True)
