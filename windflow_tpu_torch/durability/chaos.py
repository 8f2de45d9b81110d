"""Failure-injection harness: seeded kills, restore, record-for-record
A/B diff (the port of ``windflow_tpu/durability/chaos.py``).

The experiment, per (graph family, kill point, fusion on/off) cell:

1. **Baseline** — run the factory's graph uninterrupted (durability ON,
   same epoch cadence) and read the sunk output.
2. **Chaos** — run an identical graph (own broker/output/checkpoint
   store), kill it at the seeded point, ``PipeGraph.restore()`` a fresh
   instance from the last complete epoch, drive it to completion, read
   the sunk output.
3. **Verdict** — the two outputs must match record for record: no loss,
   no duplicates, no reordering within a partition.

Kill points:

* ``mid_epoch`` — raise :class:`ChaosKill` on the N-th scheduler sweep
  (between checkpoints: operator state is mid-stream, sinks hold
  uncommitted buffered output).
* ``mid_window`` — raise in the N-th batch processed by a named
  operator (a window/stateful replica dies with panes half-filled).  It
  wraps ``process_device_batch``, which a megastep group bypasses: on
  the card such a cell needs a tail the megastep plane refuses.
* ``mid_sink_flush`` — raise inside checkpoint K, between the sink
  epoch commit and the manifest write: the torn two-phase window where
  output is published but the epoch never committed — exactly the case
  the sink fence dedupes.

Kills are simulated in-process (the exception rides the scheduler loop's
crash path, which flushes and closes the checkpoint store); the broker,
checkpoint store, and sink files survive as the "external world" a real
restart would see.

``python -m windflow_tpu_torch.durability.chaos`` runs the matrix from
the command line (the twin of the JAX package's ``tools/wf_chaos.py``,
with its JSON and exit codes) on the card unless ``--device cpu``.
The full matrix (no ``--family``) adds the mesh rescale cells, as the
JAX tool does; ``--mesh`` runs those cells alone.  A cell's mesh is a
logical one over the cells' device repeated (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Union

from windflow_tpu_torch.basic import WindFlowError

KILL_POINTS = ("mid_epoch", "mid_window", "mid_sink_flush")


class ChaosKill(RuntimeError):
    """The injected failure.  RuntimeError so the scheduler's crash path
    treats it like any crash."""


@dataclasses.dataclass
class KillSpec:
    """One seeded kill.  ``after`` counts events at the kill point
    (sweeps, batches, or checkpoints); ``op_name`` names the victim
    operator for ``mid_window``."""

    point: str
    after: int = 3
    op_name: Optional[str] = None

    def __post_init__(self) -> None:
        if self.point not in KILL_POINTS:
            raise WindFlowError(
                f"unknown kill point '{self.point}' (one of {KILL_POINTS})")
        if self.point == "mid_window" and not self.op_name:
            raise WindFlowError("mid_window kills need op_name")


def arm(graph, spec: KillSpec) -> None:
    """Install the kill on a STARTED graph (replicas and the durability
    plane exist).  Test-only instrumentation: the plane hooks run at
    checkpoint cadence and the mid_window wrapper exists only on armed
    graphs."""
    plane = graph._durability
    if plane is None:
        raise WindFlowError("chaos needs Config.durability enabled")
    count = {"n": 0}
    if spec.point == "mid_epoch":
        def hook(site):
            if site == "sweep":
                count["n"] += 1
                if count["n"] == spec.after:
                    raise ChaosKill(f"mid_epoch kill at sweep {count['n']}")
        plane.chaos_hook = hook
    elif spec.point == "mid_sink_flush":
        def hook(site):
            if site == "post_sink_commit":
                count["n"] += 1
                if count["n"] == spec.after:
                    raise ChaosKill(
                        f"mid_sink_flush kill: checkpoint {count['n']} "
                        "died after the sink commit, before the manifest")
        plane.chaos_hook = hook
    else:  # mid_window
        victims = [op for op in graph._operators
                   if op.name == spec.op_name]
        if not victims:
            raise WindFlowError(
                f"mid_window kill: no operator named '{spec.op_name}'")
        for op in victims:
            for rep in op.replicas:
                _wrap_replica(rep, count, spec.after)


def _wrap_replica(rep, count: dict, after: int) -> None:
    orig_dev = rep.process_device_batch
    orig_single = rep.process_single

    def _maybe_kill():
        count["n"] += 1
        if count["n"] == after:
            raise ChaosKill(
                f"mid_window kill: replica {rep.op.name}[{rep.index}] "
                f"died processing batch {count['n']}")

    def dev(batch):
        _maybe_kill()
        return orig_dev(batch)

    def single(item, ts, wm):
        _maybe_kill()
        return orig_single(item, ts, wm)

    rep.process_device_batch = dev
    rep.process_single = single


def abandon(graph) -> None:
    """Post-kill teardown of the dead graph's external handles: Kafka
    consumers leave their group (a real crash gets this from the broker
    liveness timeout; in-process ghosts would keep partitions assigned
    and starve the restored run), producers close.  The checkpoint
    store was already flushed and closed by the crash path."""
    for sr in graph._source_replicas:
        c = getattr(sr, "_consumer", None)
        if c is not None:
            try:
                c.close()
            except Exception:  # lint: broad-except-ok (teardown after a
                # simulated crash: a half-dead client must not mask the
                # experiment's verdict)
                pass
    for op in graph._operators:
        if op.is_terminal:
            for rep in op.replicas:
                p = getattr(rep, "_producer", None)
                if p is not None:
                    try:
                        p.close()
                    except Exception:  # lint: broad-except-ok (same
                        # teardown stance as the consumer close above)
                        pass


def run_killed_and_restored(factory: Callable[[], object],
                            spec: KillSpec,
                            restore_factory: Optional[Callable] = None):
    """Start the factory's graph, arm the kill, drive to the crash,
    restore a fresh instance from the checkpoint store, and drive it to
    completion.  Returns the completed (restored) graph.  Raises if the
    kill never fired — a chaos cell that does not kill proves nothing.

    ``restore_factory`` (restore-on-N±1 cells) builds the RESTORED graph
    at a different keyed parallelism, exercising the rescale-on-restore
    re-bucketing (durability/rebucket.py) under the same contract."""
    g = factory()
    g.start()
    arm(g, spec)
    killed = False
    try:
        g.wait_end()
    except ChaosKill:
        killed = True
        abandon(g)
    if not killed:
        raise WindFlowError(
            f"chaos kill {spec} never fired — the run completed; "
            "lower `after` or feed more data")
    g2 = (restore_factory or factory)()
    g2.restore(g2.config.durability)
    g2.wait_end()
    return g2


def run_baseline(factory: Callable[[], object]):
    """The uninterrupted control run (same durability config)."""
    g = factory()
    g.run()
    return g


# ---------------------------------------------------------------------------
# output readers / diff
# ---------------------------------------------------------------------------

def read_topic(broker, topic: str) -> List[list]:
    """Committed values per partition, in offset order — the unit of
    Kafka's ordering guarantee, so the A/B diff compares per-partition
    sequences, never a cross-partition interleaving."""
    with broker._lock:
        parts = broker._topics.get(topic, [])
        return [[m.value for m in p.log] for p in parts]


def diff_records(baseline, chaos) -> Optional[str]:
    """None when the two outputs match record for record; otherwise the
    first divergence, rendered for a test failure message."""
    if baseline == chaos:
        return None
    if isinstance(baseline, list) and isinstance(chaos, list) \
            and len(baseline) == len(chaos):
        for i, (a, b) in enumerate(zip(baseline, chaos)):
            if a != b:
                if isinstance(a, list) and isinstance(b, list):
                    return _diff_seq(f"partition {i}", a, b)
                return f"record {i}: baseline={a!r} chaos={b!r}"
    if isinstance(baseline, list) and isinstance(chaos, list):
        return _diff_seq("output", baseline, chaos)
    return f"outputs differ: baseline={baseline!r} chaos={chaos!r}"


def _diff_seq(what: str, a: list, b: list) -> str:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return (f"{what}: first divergence at index {i}: "
                    f"baseline={a[i]!r} chaos={b[i]!r} "
                    f"(lengths {len(a)} vs {len(b)})")
    if len(a) != len(b):
        kind = "loss" if len(b) < len(a) else "duplication"
        extra = (a if len(a) > len(b) else b)[n:n + 3]
        return (f"{what}: {kind} — baseline has {len(a)} records, chaos "
                f"{len(b)}; first extra/missing: {extra!r}")
    return f"{what}: sequences differ"


# ---------------------------------------------------------------------------
# standard graph families
# ---------------------------------------------------------------------------

FAMILIES = ("window_cb", "window_tb", "reduce", "stateful",
            "stateless_chain", "window_compact")

#: per-family mid_window kill counts that land after the first
#: checkpoint and before completion at the default cell size (device
#: replicas count batches; the host reduce counts records)
MID_WINDOW_AFTER = {"window_cb": 12, "window_tb": 12, "stateful": 12,
                    "stateless_chain": 12, "reduce": 3000,
                    "window_compact": 12}

#: the operator a mid_window kill targets, per family
VICTIM = {"window_cb": "w", "window_tb": "w", "stateful": "st",
          "stateless_chain": "f", "reduce": "red", "window_compact": "w"}


def input_log(n: int, keys: int) -> list:
    """The cells' input stream as Kafka messages of partition 0: record
    ``i`` is ``{"key": i % keys, "value": float32(i % 97)}`` at event
    time ``1000 + 7 i`` µs, then an ``"EOS"`` message.  Values are small
    integers, so every family's arithmetic stays exact in float32."""
    import numpy as np

    from windflow_tpu_torch.kafka.client import KafkaMessage
    vals = [np.float32(v) for v in range(97)]
    msgs = [KafkaMessage("in", 0, i, None,
                         {"key": i % keys, "value": vals[i % 97]},
                         1_000 + i * 7) for i in range(n)]
    msgs.append(KafkaMessage("in", 0, n, None, "EOS", 1_000 + n * 7))
    return msgs


def make_cell(family: str, ckpt_dir: str, *, fusion: bool = True,
              out_dir: Optional[str] = None, n: int = 4096,
              keys: int = 8, app: str = "chaos",
              epoch_sweeps: int = 3, parallelism: int = 1,
              output_batch_size: int = 256, messages: Optional[list] = None,
              **cfg) -> dict:
    """One isolated chaos cell: its own in-memory broker pre-filled with
    a deterministic event-time stream (``input_log``, or ``messages``
    to share one stream between cells), a graph factory (re-invocable:
    the chaos path builds the graph twice; it also accepts a
    ``parallelism=`` override so a rescale cell can restore the same
    cell on a different shard shape), and an output reader.  ``cfg``
    sets fields of the graphs' ``Config`` (``device``,
    ``megastep_sweeps``, ``wire_compression``, ...).  Returns
    ``{"factory", "read", "broker"}``.

    Determinism contract: EVENT-time records, interval punctuation
    pushed out of reach, sweep-counted epoch cadence — so the baseline
    run, the killed run, and the replay all stage identical batches in
    identical order, which is what makes the record-for-record diff
    (and the sink fence's seq-dedupe) exact."""
    import numpy as np

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.kafka.client import InMemoryBroker
    from windflow_tpu_torch.kafka.kafka_sink import (KafkaSink,
                                                     KafkaSinkMessage)
    from windflow_tpu_torch.kafka.kafka_source import KafkaSource
    if family not in FAMILIES:
        raise WindFlowError(
            f"unknown chaos family '{family}' (one of {FAMILIES})")
    broker = InMemoryBroker()
    broker.create_topic("in", 1)
    broker._topics["in"][0].log.extend(
        messages if messages is not None else input_log(n, keys))

    def deser(msg, shipper):
        if msg is None:
            return True
        if msg.value == "EOS":
            return False
        # the float32 value lane makes the staged records pack, so the
        # A/B exercises the wire-compressed staging path where the wire
        # is on
        shipper.pushWithTimestamp(msg.value, msg.timestamp_usec)
        return True

    file_sink = None
    if family == "stateless_chain":
        if out_dir is None:
            raise WindFlowError("stateless_chain needs out_dir")
        from windflow_tpu_torch.durability.sinks import EpochFileSink
        file_sink = EpochFileSink(out_dir)

    def factory(parallelism: int = parallelism, **over):
        # ``over``: Config fields of this build only (a rescale cell's
        # restore mesh)
        c = dataclasses.replace(wt.default_config, **{**cfg, **over})
        c.durability = ckpt_dir
        c.durability_epoch_sweeps = epoch_sweeps
        c.whole_chain_fusion = fusion
        # determinism: interval punctuation reads the wall clock, which
        # would move batch boundaries between runs
        c.punctuation_interval_usec = 10 ** 12
        src = KafkaSource(deser, broker, ["in"], group_id="chaos",
                          name="ksrc", output_batch_size=output_batch_size)
        # declared record spec: lets the wire plane compress this edge
        src.record_spec = {"key": np.int64(0), "value": np.float32(0.0)}
        g = wt.PipeGraph(app, config=c)
        pipe = g.add_source(src)
        ser = (lambda r: KafkaSinkMessage(
            "out", tuple(sorted((k, round(float(v), 6))
                                for k, v in r.items()))))
        if family in ("window_cb", "window_tb"):
            pipe.add(wt.MapGPU_Builder(
                lambda t: {"key": t["key"], "value": t["value"] * 2.0})
                .withName("m").build())
            wb = wt.Ffat_WindowsGPU_Builder(lambda t: t["value"],
                                            lambda a, b: a + b)
            wb = (wb.withCBWindows(16, 8) if family == "window_cb"
                  else wb.withTBWindows(70, 35))
            pipe.add(wb.withKeyBy(lambda t: t["key"])
                     .withParallelism(parallelism)
                     .withMaxKeys(keys).withName("w").build())
            pipe.add_sink(KafkaSink(ser, broker, name="ksnk"))
        elif family == "window_compact":
            # compacted key space: the pane rings index by REMAP slots,
            # so the cell proves the remap table restores exactly.  Keys
            # are arbitrary sparse int32; the window is host-fed (keyed
            # staging edge), so every key admits at the boundary
            pipe.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["value"],
                                                lambda a, b: a + b)
                     .withCBWindows(16, 8)
                     .withKeyBy(lambda t: t["key"] * 131 + 7)
                     .withCompactedKeys().withName("w").build())
            pipe.add_sink(KafkaSink(ser, broker, name="ksnk"))
        elif family == "stateful":
            pipe.add(wt.MapGPU_Builder(
                lambda t: {"key": t["key"], "value": t["value"] + 1.0})
                .withName("m").build())

            def st_fn(t, s):
                ns = {"n": s["n"] + 1, "s": s["s"] + t["value"]}
                return ({"key": t["key"], "value": t["value"],
                         "n": ns["n"], "s": ns["s"]}, ns)

            pipe.add(wt.MapGPU_Builder(st_fn)
                     .withInitialState({"n": 0, "s": 0.0})
                     .withKeyBy(lambda t: t["key"])
                     .withParallelism(parallelism)
                     .withNumKeySlots(keys).withDenseKeys()
                     .withName("st").build())
            pipe.add_sink(KafkaSink(ser, broker, name="ksnk"))
        elif family == "reduce":
            def red_fn(item, state):
                state["key"] = item["key"]
                state["n"] = state.get("n", 0) + 1
                state["s"] = round(state.get("s", 0.0) + item["value"], 6)

            pipe.add(wt.Reduce_Builder(red_fn, dict)
                     .withKeyBy(lambda t: t["key"])
                     .withParallelism(parallelism)
                     .withName("red").build())
            pipe.add_sink(KafkaSink(ser, broker, name="ksnk"))
        else:  # stateless_chain -> exactly-once epoch file sink
            pipe.add(wt.MapGPU_Builder(
                lambda t: {"key": t["key"], "value": t["value"] * 3.0})
                .withName("m").build())
            pipe.add(wt.FilterGPU_Builder(lambda t: (t["key"] & 1) == 0)
                     .withName("f").build())
            pipe.add_sink(wt.Sink_Builder(file_sink).withName("fsink")
                          .build())
        return g

    if family == "stateless_chain":
        from windflow_tpu_torch.durability.sinks import EpochFileSink as _EFS

        def read():
            return _EFS.read_committed(out_dir)
    else:
        def read():
            return read_topic(broker, "out")

    return {"factory": factory, "read": read, "broker": broker}


def default_kill(family: str, point: str) -> KillSpec:
    """The seeded kill each (family, point) cell uses by default."""
    if point == "mid_window":
        return KillSpec(point, after=MID_WINDOW_AFTER[family],
                        op_name=VICTIM[family])
    if point == "mid_sink_flush":
        return KillSpec(point, after=2)
    return KillSpec(point, after=6)


# ---------------------------------------------------------------------------
# kill-a-shard / restore-on-N±1 (rescale) cells
# ---------------------------------------------------------------------------

#: families whose keyed operator rescales across replica shard counts
#: (kill at parallelism P, restore at P±1); stateless_chain has no
#: keyed operator and window_compact's remap already rides the blob
RESCALE_FAMILIES = ("reduce", "stateful", "window_cb", "window_tb")

#: families that rescale across mesh shapes (killed on kk key shards,
#: restored on another key axis)
MESH_RESCALE_FAMILIES = ("window_cb", "window_tb")


def record_key(rec):
    """The routing key of one sunk record (the cells' serializer ships
    sorted (field, value) pair tuples)."""
    try:
        return dict(rec).get("key")
    except (TypeError, ValueError):
        return None


def keyed_sequences(parts: List[list]) -> dict:
    """Per-key record sequences in offset order.  Under keyed routing
    the per-KEY subsequence is the unit of the ordering guarantee — a
    shard-count change legitimately re-interleaves keys against each
    other."""
    out: dict = {}
    for p in parts:
        for rec in p:
            out.setdefault(record_key(rec), []).append(rec)
    return out


def diff_keyed_records(baseline, chaos) -> Optional[str]:
    """None when every key's record sequence matches exactly; otherwise
    the first per-key divergence.  The rescale form of
    :func:`diff_records`: loss, duplication, or per-key reorder all
    surface — only the cross-key interleaving is factored out."""
    a, b = keyed_sequences(baseline), keyed_sequences(chaos)
    for k in sorted(set(a) | set(b), key=repr):
        if k not in a:
            return f"key {k!r}: {len(b[k])} record(s) only in chaos run"
        if k not in b:
            return f"key {k!r}: {len(a[k])} record(s) only in baseline"
        if a[k] != b[k]:
            return _diff_seq(f"key {k!r}", a[k], b[k])
    return None


def _count(out) -> int:
    return sum(len(p) for p in out) \
        if out and isinstance(out[0], list) else len(out)


def _verdict(gb, gc, base_out, chaos_out, diff, seconds) -> dict:
    """The verdict fields shared by :func:`run_ab` and
    :func:`run_rescale_ab`: the diff, the records compared, the
    baseline's epochs and checkpoint cost, the restore's epoch and cost,
    the sink dedupes, and the host seconds of the baseline run and of
    the whole cell."""
    db = gb.stats()["Durability"]
    dur = gc.stats()["Durability"]
    return {
        "diff": diff,
        "records": _count(base_out),
        "restored_epoch": dur.get("restored_epoch"),
        "restore_ms": dur.get("restore_ms"),
        "epochs_committed_baseline": db.get("epochs_committed"),
        "checkpoint_ms_total": db.get("checkpoint_ms_total"),
        "snapshot_ms_total": db.get("snapshot_ms_total"),
        "checkpoint_bytes_total": db.get("checkpoint_bytes_total"),
        "last_checkpoint_bytes": db.get("last_checkpoint_bytes"),
        "dedupe_hits": dur.get("dedupe_hits"),
        "baseline_seconds": seconds[0],
        "seconds": seconds[1],
    }


def run_rescale_ab(family: str, point: str, workdir: str, *,
                   shards_kill: int, shards_restore: int,
                   mesh_kill=None, mesh_restore=None,
                   n: int = 4096, fusion: bool = True,
                   spec: Union[None, KillSpec,
                               Callable[[object], KillSpec]] = None,
                   **cell) -> dict:
    """One kill-a-shard / restore-on-N±1 cell: baseline runs
    uninterrupted on the KILL shape; the chaos twin is killed on the
    kill shape and restored on the RESTORE shape (parallelism and/or
    mesh).  The diff is per-key record-for-record.  ``spec`` is as in :func:`run_ab` (the
    family's default kill when None); ``cell`` passes on to
    :func:`make_cell` (``keys``, ``output_batch_size``, ``messages``,
    Config fields)."""
    import os as _os
    tag = (f"rescale_{family}_{point}_{shards_kill}to{shards_restore}"
           f"_{_mesh_tag(mesh_kill)}to{_mesh_tag(mesh_restore)}"
           f"_{'on' if fusion else 'off'}")
    if mesh_kill is not None:
        cell["mesh"] = mesh_kill
    base = make_cell(family, _os.path.join(workdir, tag, "ckpt_a"),
                     fusion=fusion, n=n, parallelism=shards_kill,
                     out_dir=_os.path.join(workdir, tag, "out_a"), **cell)
    chal = make_cell(family, _os.path.join(workdir, tag, "ckpt_b"),
                     fusion=fusion, n=n, parallelism=shards_kill,
                     out_dir=_os.path.join(workdir, tag, "out_b"), **cell)
    if spec is None:
        spec = default_kill(family, point)
        if point == "mid_window" and shards_kill > 1 \
                and family != "reduce":
            # device families count BATCHES, shared across replicas: P
            # keyed partitions stage ~P× as many (smaller) batches by
            # the same stream position
            spec = KillSpec(point, after=spec.after * shards_kill,
                            op_name=spec.op_name)
    t0 = time.perf_counter()
    gb = run_baseline(base["factory"])
    t1 = time.perf_counter()
    if callable(spec):
        spec = spec(gb)
    gc = run_killed_and_restored(
        chal["factory"], spec,
        restore_factory=lambda: chal["factory"](
            parallelism=shards_restore, mesh=mesh_restore))
    seconds = (t1 - t0, time.perf_counter() - t0)
    base_out, chaos_out = base["read"](), chal["read"]()
    out = {"family": family, "point": point, "rescale": True,
           "shards": f"{shards_kill}->{shards_restore}",
           "mesh": None if mesh_kill is None else
           f"{_mesh_tag(mesh_kill)}->{_mesh_tag(mesh_restore)}",
           "fusion": fusion, "kill": dataclasses.asdict(spec)}
    out.update(_verdict(gb, gc, base_out, chaos_out,
                        diff_keyed_records(base_out, chaos_out), seconds))
    return out


def _mesh_tag(mesh) -> str:
    if mesh is None:
        return "none"
    from windflow_tpu_torch.durability.rebucket import mesh_shape
    s = mesh_shape(mesh)
    return f"{s['data']}x{s['key']}"


def run_ab(factory_baseline: Optional[Callable[[], object]],
           factory_chaos: Callable[[], object],
           spec: Union[KillSpec, Callable[[object], KillSpec]],
           read_baseline: Callable[[], object],
           read_chaos: Callable[[], object],
           baseline=None) -> dict:
    """One chaos cell end to end.  The two factories must build
    IDENTICAL graphs over identical input but isolated externals (own
    broker/topic/checkpoint dir/output dir).  ``spec`` may be a callable
    that picks the kill from the completed baseline graph (its sweep,
    epoch and batch counts), so a cell of any size kills after its
    first committed epoch and before its end.  ``baseline``, a
    completed baseline graph (whose output ``read_baseline`` reads),
    replaces the baseline run, so several kills share one.  ``diff`` is
    None on exactly-once."""
    t0 = time.perf_counter()
    gb = baseline if baseline is not None \
        else run_baseline(factory_baseline)
    t1 = time.perf_counter()
    if callable(spec):
        spec = spec(gb)
    gc = run_killed_and_restored(factory_chaos, spec)
    seconds = (t1 - t0, time.perf_counter() - t0)
    base_out, chaos_out = read_baseline(), read_chaos()
    out = {"kill": dataclasses.asdict(spec)}
    out.update(_verdict(gb, gc, base_out, chaos_out,
                        diff_records(base_out, chaos_out), seconds))
    return out


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def run_cell(family: str, point: str, fusion: bool, records: int,
             workdir: str, **cfg) -> dict:
    """One (family, kill point, fusion) cell of the matrix, each run in
    its own checkpoint and output directories under ``workdir``."""
    import os
    tag = f"{family}_{point}_{'on' if fusion else 'off'}"
    base = make_cell(family, os.path.join(workdir, tag, "ckpt_a"),
                     fusion=fusion, n=records,
                     out_dir=os.path.join(workdir, tag, "out_a"), **cfg)
    chal = make_cell(family, os.path.join(workdir, tag, "ckpt_b"),
                     fusion=fusion, n=records,
                     out_dir=os.path.join(workdir, tag, "out_b"), **cfg)
    verdict = run_ab(base["factory"], chal["factory"],
                     default_kill(family, point), base["read"],
                     chal["read"])
    verdict.update(family=family, point=point, fusion=fusion)
    return verdict


def run_rescale_cells(families, records: int, workdir: str,
                      with_mesh: bool = False, replicas: bool = True,
                      **cfg) -> list:
    """Kill-a-shard / restore-on-N±1 cells: each rescale family killed
    at 3 replicas and restored on 2 and on 4; ``with_mesh`` adds the mesh
    families killed on 4 key shards and restored on 2, and the reverse
    (logical meshes over the cells' device)."""
    out = []
    for family in (families if replicas else ()):
        for shards_restore in (2, 4):
            v = run_rescale_ab(family, "mid_epoch", workdir, shards_kill=3,
                               shards_restore=shards_restore, n=records,
                               **cfg)
            out.append(v)
    if with_mesh:
        from windflow_tpu_torch.parallel.mesh import make_mesh
        dev = cfg.get("device", "cuda")
        for family in MESH_RESCALE_FAMILIES:
            if family not in families:
                continue
            for kk_kill, kk_restore in ((4, 2), (2, 4)):
                out.append(run_rescale_ab(
                    family, "mid_epoch", workdir, shards_kill=1,
                    shards_restore=1,
                    mesh_kill=make_mesh(kk_kill, devices=[dev] * kk_kill),
                    mesh_restore=make_mesh(kk_restore,
                                           devices=[dev] * kk_restore),
                    n=records, **cfg))
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import tempfile
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.durability.chaos",
        description="failure-injection harness for the durability plane")
    ap.add_argument("--family", choices=FAMILIES, action="append",
                    help="graph family (repeatable; default: all)")
    ap.add_argument("--point", choices=KILL_POINTS, action="append",
                    help="kill point (repeatable; default: all)")
    ap.add_argument("--fusion", choices=("on", "off", "both"),
                    default="both")
    ap.add_argument("--records", type=int, default=4096)
    ap.add_argument("--rescale", choices=("on", "off"), default="on",
                    help="also run the kill-a-shard / restore-on-N±1 "
                         "rescale cells (per-key record diff)")
    ap.add_argument("--mesh", action="store_true",
                    help="run only the mesh rescale cells (logical "
                         "meshes over --device)")
    ap.add_argument("--device", default="cuda",
                    help="Config.device of the cells' graphs (default: "
                         "the card)")
    ap.add_argument("--workdir", default=None,
                    help="directory for checkpoint stores and sink files "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    families = args.family or list(FAMILIES)
    points = args.point or list(KILL_POINTS)
    fusions = {"on": [True], "off": [False],
               "both": [True, False]}[args.fusion]
    workdir = args.workdir or tempfile.mkdtemp(prefix="wf_chaos_")
    cfg = {"device": args.device}
    results, failed = [], 0
    if args.mesh:
        # the mesh rescale cells alone
        families, args.rescale = [f for f in families
                                  if f in MESH_RESCALE_FAMILIES], "on"
    for family in (families if not args.mesh else ()):
        for point in points:
            for fusion in fusions:
                v = run_cell(family, point, fusion, args.records, workdir,
                             **cfg)
                results.append(v)
                ok = v["diff"] is None
                failed += 0 if ok else 1
                if not args.json:
                    print(f"{'OK  ' if ok else 'FAIL'} {family:<16} "
                          f"{point:<15} fusion={'on ' if fusion else 'off'}"
                          f" records={v['records']:<6} "
                          f"restored_epoch={v['restored_epoch']} "
                          f"dedupe={v['dedupe_hits']}"
                          + ("" if ok else f"\n     {v['diff']}"))
    if args.rescale == "on":
        rescale_fams = [f for f in RESCALE_FAMILIES if f in families]
        if args.family and not rescale_fams:
            print("wf_chaos: none of the selected families "
                  f"({families}) has a rescale cell "
                  f"(rescale families: {list(RESCALE_FAMILIES)})",
                  file=sys.stderr)
        # the mesh cells ride the full matrix, as in the JAX tool
        with_mesh = args.mesh or not args.family
        for v in run_rescale_cells(rescale_fams, args.records, workdir,
                                   with_mesh=with_mesh,
                                   replicas=not args.mesh, **cfg):
            results.append(v)
            ok = v["diff"] is None
            failed += 0 if ok else 1
            if not args.json:
                shape = v["mesh"] or v["shards"]
                print(f"{'OK  ' if ok else 'FAIL'} "
                      f"{v['family']:<16} {v['point']:<15} "
                      f"rescale={shape:<8} records={v['records']:<6} "
                      f"restored_epoch={v['restored_epoch']}"
                      + ("" if ok else f"\n     {v['diff']}"))
    if args.json:
        json.dump(results, sys.stdout, indent=1)
        print()
    n_rescale = sum(1 for v in results if v.get("rescale"))
    n_eo = len(results) - n_rescale
    if failed:
        print(f"wf_chaos: FAIL — {failed}/{len(results)} cell(s) "
              "violated their contract (exactly-once cells must hold)",
              file=sys.stderr)
        return 1
    print(f"wf_chaos: OK — {n_eo} cell(s) held exactly-once"
          + (f", {n_rescale} rescale (kill-a-shard / restore-on-N±1) "
             "cell(s) held per-key exact" if n_rescale else "")
          + f" (workdir {workdir})")
    return 0


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(main())
