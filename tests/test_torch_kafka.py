"""The port's Kafka layer (windflow_tpu_torch/kafka) against
the JAX package's (windflow_tpu/kafka), on the CPU: the families of
tests/test_kafka.py the durability chaos cells rely on — consumer-group
assignment (:27), positions kept across a rebalance (:42), explicit
offsets (:60), checkpoint positions and seek, the source at parallelism
2-4 covering every partition (:114, :122), the riched context (:144),
the fenced exactly-once commit (tests/test_durability.py:653) and the
sink's EOS flush-and-fence (:579) — plus a Kafka-fed count-window graph
whose records equal the JAX package's; and the confluent adapters:
their refusal without the package (:169) and their paths against a
faked module (:173-272).

Tolerance: exact (integer-valued data)."""

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu import kafka as jk
from windflow_tpu_torch import kafka as tk

torch.set_num_threads(1)

IDS = ["port", "jax"]


def fill_topic(broker, topic, n, partitions=4):
    broker.create_topic(topic, partitions)
    prod = broker.producer()
    for i in range(n):
        prod.produce(topic, {"key": i % 8, "value": i},
                     key=str(i % 8).encode())
    prod.flush()
    return prod


def _cfg(pkg):
    if pkg is wt:
        return wt.Config(device="cpu")
    return None


# ---------------------------------------------------------------------------
# broker semantics: both packages give the same assignment and reads
# ---------------------------------------------------------------------------

def _group_reads(kmod):
    broker = kmod.InMemoryBroker()
    fill_topic(broker, "t", 100, partitions=6)
    cs = [broker.consumer() for _ in range(3)]
    for c in cs:
        c.subscribe(["t"], "g1")
    parts = [sorted(c.assignment()) for c in cs]
    got = [[m.value["value"] for m in c.poll(1000)] for c in cs]
    return parts, got


def test_consumer_group_partitions_disjoint_and_complete():
    parts, got = _group_reads(tk)
    assert set().union(*map(set, parts)) == {("t", p) for p in range(6)}
    assert sum(len(p) for p in parts) == 6
    assert sorted(v for g in got for v in g) == list(range(100))
    assert (parts, got) == _group_reads(jk)


@pytest.mark.parametrize("kmod", [tk, jk], ids=IDS)
def test_rebalance_resumes_positions(kmod):
    broker = kmod.InMemoryBroker()
    fill_topic(broker, "t", 60, partitions=2)
    c1 = broker.consumer()
    c1.subscribe(["t"], "g")
    first = c1.poll(30)
    assert len(first) == 30
    c2 = broker.consumer()
    c2.subscribe(["t"], "g")
    assert len(c1.assignment()) == 1 and len(c2.assignment()) == 1
    rest = [m.value["value"] for c in (c1, c2) for m in c.poll(1000)]
    assert sorted([m.value["value"] for m in first] + rest) == \
        list(range(60))
    c1.close()
    assert len(c2.assignment()) == 2


@pytest.mark.parametrize("kmod", [tk, jk], ids=IDS)
def test_explicit_offsets(kmod):
    broker = kmod.InMemoryBroker()
    fill_topic(broker, "t", 20, partitions=1)
    c = broker.consumer()
    c.subscribe(["t"], "g_off", offsets=[15])
    assert [m.value["value"] for m in c.poll(100)] == list(range(15, 20))


def _positions_then_seek(kmod):
    broker = kmod.InMemoryBroker()
    fill_topic(broker, "t", 40, partitions=2)
    c = broker.consumer()
    c.subscribe(["t"], "g")
    c.poll(10)
    pos = c.positions()
    after = [m.value["value"] for m in c.poll(1000)]
    c.seek_positions(pos)                  # the restore path's rewind
    again = [m.value["value"] for m in c.poll(1000)]
    return pos, after, again


def test_positions_and_seek_replay_the_same_messages():
    """A checkpoint records the group's next-poll offsets; seeking back
    to them replays exactly the messages read since, in both packages."""
    pos, after, again = _positions_then_seek(tk)
    assert sum(pos.values()) == 10 and after == again and len(after) == 30
    assert (pos, after, again) == _positions_then_seek(jk)


@pytest.mark.parametrize("kmod", [tk, jk], ids=IDS)
def test_broker_fence_dedupes_on_lifetime_seq(kmod):
    broker = kmod.InMemoryBroker()
    broker.create_topic("t", 1)
    msgs = [(s, "t", f"m{s}", None, None, 1000 + s) for s in (1, 2, 3)]
    assert broker.fenced_commit("f", 0, msgs) == (3, 0)
    replay = msgs[1:] + [(4, "t", "m4", None, None, 1004)]
    assert broker.fenced_commit("f", 1, replay) == (1, 2)
    assert broker.fence("f") == (1, 4)
    assert broker.topic_size("t") == 4


def test_kafka_sink_eos_flush_and_fence():
    """tests/test_durability.py:579 — on_eos flushes AND fences: a
    straggler tuple after the EOS flush raises."""
    broker = tk.InMemoryBroker()
    broker.create_topic("out", 1)
    snk = tk.KafkaSink(lambda r: tk.KafkaSinkMessage("out", r), broker,
                       name="ks")
    snk.build_replicas(wt.ExecutionMode.DEFAULT, wt.TimePolicy.INGRESS)
    rep = snk.replicas[0]
    rep.process_single({"v": 1}, 10, 10)
    rep.on_eos()
    assert rep._fenced and broker.topic_size("out") == 1
    with pytest.raises(wt.WindFlowError, match="flush-and-fence"):
        rep.process_single({"v": 2}, 11, 11)


def test_real_broker_is_not_ported():
    """A bootstrap address goes to the confluent adapters; without the
    package both refuse, naming it (``tests/test_kafka.py:169``)."""
    from windflow_tpu_torch.kafka.client import make_consumer, make_producer
    for make in (make_consumer, make_producer):
        with pytest.raises(wt.WindFlowError, match="confluent_kafka"):
            make("localhost:9092")


def test_confluent_adapter_paths_with_fake_module():
    """The port's confluent adapters (tests/test_kafka.py:173-272) against a
    faked ``confluent_kafka`` module: subscribe with offset seeking, the
    poll loop's error filtering and timestamp mapping, produce with the
    BufferError backpressure retry, and the restore cursors staged for
    on_assign (``seek_positions``)."""
    import sys
    import types

    log = {"produced": [], "assigned": [], "polled": 0}

    class FakeMsg:
        def __init__(self, topic, part, off, key, value, err=None, ts=(1, 5)):
            self._t, self._p, self._o = topic, part, off
            self._k, self._v, self._e, self._ts = key, value, err, ts

        def topic(self): return self._t
        def partition(self): return self._p
        def offset(self): return self._o
        def key(self): return self._k
        def value(self): return self._v
        def error(self): return self._e
        def timestamp(self): return self._ts

    class FakeTP:
        def __init__(self, topic, partition=0):
            self.topic, self.partition, self.offset = topic, partition, -1001

    class FakeConsumer:
        def __init__(self, conf):
            self.conf = conf
            self._queue = [
                FakeMsg("t", 0, 7, b"k", b"v0"),
                FakeMsg("t", 0, 8, None, b"bad", err="boom"),
                FakeMsg("t", 0, 9, None, b"v1", ts=(0, 0)),
            ]

        def subscribe(self, topics, on_assign=None):
            parts = [FakeTP(t) for t in topics]
            if on_assign:
                on_assign(self, parts)
            self._assigned = parts

        def incremental_assign(self, partitions):
            log["assigned"] = [(p.topic, p.partition, p.offset)
                               for p in partitions]

        def poll(self, timeout):
            log["polled"] += 1
            return self._queue.pop(0) if self._queue else None

        def assignment(self):
            return self._assigned

        def close(self):
            pass

    class FakeProducer:
        def __init__(self, conf):
            self._fail_once = True

        def produce(self, topic, value=None, key=None, **kw):
            if self._fail_once:
                self._fail_once = False
                raise BufferError("queue full")
            log["produced"].append((topic, value, key, kw))

        def poll(self, timeout):
            return 0

        def flush(self):
            log["flushed"] = True

    fake = types.ModuleType("confluent_kafka")
    fake.Consumer = FakeConsumer
    fake.Producer = FakeProducer
    fake.TopicPartition = FakeTP
    sys.modules["confluent_kafka"] = fake
    try:
        from windflow_tpu_torch.kafka.client import make_consumer, make_producer
        c = make_consumer("broker:9092")
        c.subscribe(["t"], "grp", offsets=[7])
        assert log["assigned"] == [("t", 0, 7)]   # offset seeking ran
        msgs = c.poll(10)
        # the errored message is filtered; broker ts and ingest ts both map
        assert [m.value for m in msgs] == [b"v0", b"v1"]
        assert msgs[0].offset == 7 and msgs[0].timestamp_usec == 5000
        assert msgs[1].timestamp_usec > 0
        assert c.assignment() == [("t", 0)]
        c.seek_positions({("t", 1): 42})
        assert c._pending_seek == {("t", 1): 42}
        c.close()

        p = make_producer("broker:9092")
        p.produce("t", b"x", key=b"kk", partition=3, timestamp_usec=9000)
        assert log["produced"] == [("t", b"x", b"kk",
                                    {"partition": 3, "timestamp": 9})]
        p.close()
        assert log.get("flushed")
    finally:
        del sys.modules["confluent_kafka"]


# ---------------------------------------------------------------------------
# operators in graphs
# ---------------------------------------------------------------------------

def run_kafka_graph(pkg, kmod, par, n=200):
    broker = kmod.InMemoryBroker()
    fill_topic(broker, "in", n, partitions=4)
    broker.create_topic("out", 2)
    seen = {"eos_idle": 0}

    def deser(msg, shipper, ctx):
        if msg is None:
            seen["eos_idle"] += 1
            return False
        shipper.pushWithTimestamp(msg.value, msg.timestamp_usec)
        return True

    def ser(item, ctx):
        if item["value"] % 2:
            return None
        return kmod.KafkaSinkMessage(topic="out", payload=item["value"],
                                     key=str(item["key"]).encode())

    src = (kmod.KafkaSource_Builder(deser).withBrokers(broker)
           .withTopics("in").withGroupID("g").withIdleness(0)
           .withParallelism(par[0]).build())
    mp_op = (pkg.Map_Builder(lambda t: {"key": t["key"],
                                        "value": t["value"] * 3})
             .withParallelism(par[1]).build())
    snk = (kmod.KafkaSink_Builder(ser).withBrokers(broker)
           .withParallelism(par[2]).build())
    g = pkg.PipeGraph("kafka_graph", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg))
    g.add_source(src).add(mp_op).add_sink(snk)
    g.run()
    c = broker.consumer()
    c.subscribe(["out"], "check")
    return sorted(m.value for m in c.poll(10_000)), seen


@pytest.mark.parametrize("par", [(1, 1, 1), (2, 2, 2), (4, 1, 3)])
def test_kafka_source_to_sink(par):
    """:114 — replicas at parallelism 1-4 join one group, every
    partition is read once, one idle stop a source replica."""
    vals, seen = run_kafka_graph(wt, tk, par)
    assert vals == sorted(v * 3 for v in range(200) if (v * 3) % 2 == 0)
    assert seen["eos_idle"] == par[0]
    assert (vals, seen) == run_kafka_graph(wf, jk, par)


def test_kafka_context_exposes_clients():
    broker = tk.InMemoryBroker()
    fill_topic(broker, "in", 10, partitions=1)
    seen = {}

    def deser(msg, shipper, ctx):
        seen["consumer"] = ctx.consumer is not None
        seen["assignment"] = ctx.consumer.assignment()
        if msg is None:
            return False
        shipper.push(msg.value)
        return True

    src = (tk.KafkaSource_Builder(deser).withBrokers(broker)
           .withTopics("in").withIdleness(0).build())
    g = wt.PipeGraph("kafka_ctx", config=wt.Config(device="cpu"))
    g.add_source(src).add_sink(wt.Sink_Builder(lambda t: None).build())
    g.run()
    assert seen == {"consumer": True, "assignment": [("in", 0)]}


def _kafka_window(pkg, kmod):
    """A Kafka-fed keyed count-window graph (event time from the
    messages, float32 values): the records both packages emit."""
    broker = kmod.InMemoryBroker()
    broker.create_topic("in", 2)
    p = broker.producer()
    for i in range(1024):
        p.produce("in", {"key": i % 5, "value": float(i % 13)},
                  partition=i % 2, timestamp_usec=1_000 + 3 * i)
    got = []

    def deser(msg, shipper):
        if msg is None:
            return False
        shipper.pushWithTimestamp(
            {"key": msg.value["key"],
             "value": np.float32(msg.value["value"])}, msg.timestamp_usec)
        return True

    src = (kmod.KafkaSource_Builder(deser).withBrokers(broker)
           .withTopics("in").withIdleness(0).withOutputBatchSize(64)
           .build())
    dev = "GPU" if pkg is wt else "TPU"
    win = (getattr(pkg, f"Ffat_Windows{dev}_Builder")(
        lambda t: t["value"], lambda a, b: a + b)
        .withCBWindows(8, 4).withKeyBy(lambda t: t["key"])
        .withMaxKeys(5).build())
    g = pkg.PipeGraph("kafka_win", config=_cfg(pkg))
    g.add_source(src).add(win).add_sink(pkg.Sink_Builder(
        lambda r: got.append(tuple(sorted((k, float(v))
                                          for k, v in r.items())))
        if r is not None else None).build())
    g.run()
    return got


def test_kafka_fed_window_graph_equals_jax():
    got = _kafka_window(wt, tk)
    assert len(got) > 200
    assert got == _kafka_window(wf, jk)
