"""Watermark-aligned checkpoint/restore: the DurabilityPlane (the port of
``windflow_tpu/durability/checkpoint.py``).

Protocol (the whole correctness argument lives in these five steps, in
this order):

1. **Barrier (quiesce).**  The scheduler stops ticking sources, flushes
   every live emitter's open batch (a staging edge's external flush also
   drains its megastep queue batch by batch), and drains replicas until
   the graph is idle.  The host scheduler is one cooperative loop, so this
   is a perfectly aligned snapshot point: no record is both in flight
   and in state, and the barrier IS the epoch marker.
2. **Sink epoch commit.**  Exactly-once sinks publish the epoch's
   buffered output atomically: the Kafka sink through the broker-side
   fence (dedupe on the replica's lifetime sequence number,
   ``kafka/client.py fenced_commit``), file sinks by renaming their
   staged epoch file into place.  Commit comes BEFORE the manifest: a
   crash between 2 and 4 re-commits the epoch on replay and the fence /
   idempotent rename dedupes it.
3. **State snapshot.**  Every operator's ``snapshot_state()`` blob plus
   per-replica watermark/offset bookkeeping is written into the LogKV
   under epoch-versioned keys.  Blobs hold numpy only, copied off the
   live tensors: on the card that copy is the one host read durability
   pays, at checkpoint cadence; the steps between checkpoints stay free
   of host reads.
4. **Manifest commit.**  One ``ep/<e>/manifest`` record (topology
   signature + counters) is appended LAST, then the log is fsynced.  The
   LogKV's open-time torn-tail truncation makes this the atomic commit
   point: an epoch exists iff its manifest survived.
5. **GC.**  Epochs older than ``Config.durability_keep`` are tombstoned;
   LogKV auto-compaction reclaims the space.

``restore_graph`` (surfaced as ``PipeGraph.restore()``) inverts it: find
the last complete epoch, validate the manifest's topology signature
against the composed graph (WF602 named diff on mismatch), stash the
blobs, ``start()`` the graph, apply operator/replica state after
``_build`` and before the first source tick, and seek Kafka consumers
back to the checkpointed offsets.

The store format, the key layout and each operator's blob are the JAX
package's, so an operator blob written by one package restores into the
other's operator.  The manifest names the port's operator types, so a
whole JAX checkpoint fails WF602 against a port graph, as it should.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional

from windflow_tpu_torch.basic import WindFlowError, current_time_usecs

CHECKPOINT_SCHEMA = "wf-checkpoint/1"

#: safety valve on the quiesce drain: a graph that cannot drain within
#: this many flush+drain rounds is wedged (each round moves data at
#: least one hop; real graphs quiesce in a handful)
_MAX_QUIESCE_ROUNDS = 100_000


def topology_signature(ops) -> list:
    """Stable per-operator signature the manifest pins and restore
    validates (WF602): enough to prove the restored graph rebuilds the
    same state layout, not so much that a cosmetic change breaks it.
    The ``is_tpu`` field keeps the JAX package's name and records the
    port's ``is_gpu``."""
    sig = []
    for op in ops:
        sig.append({
            "name": op.name,
            "type": type(op).__name__,
            "parallelism": op.parallelism,
            "routing": op.routing.value,
            "is_tpu": bool(op.is_gpu),
            "record_spec": _spec_str(getattr(op, "record_spec", None)),
        })
    return sig


def _spec_str(spec) -> Optional[str]:
    """A record spec (an example record of numpy scalars/arrays or
    tensors) described as ``path:shape/dtype`` per leaf, in the
    canonical leaf order."""
    if spec is None:
        return None
    import numpy as np

    def leaves(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k], f"{path}.{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                yield from leaves(c, f"{path}[{i}]")
        else:
            shape = tuple(getattr(node, "shape", ()))
            dtype = getattr(node, "dtype", None)
            if dtype is None:
                dtype = np.asarray(node).dtype
            yield f"{path}:{shape}/{str(dtype).replace('torch.', '')}"

    try:
        return ";".join(leaves(spec, ""))
    except Exception:  # lint: broad-except-ok (an exotic record
        # declaration must not block checkpointing — the signature
        # simply omits it and topology still validates)
        return None


def quiesce(graph) -> None:
    """Drain a started graph to the aligned barrier: flush open emitter
    batches, then drain replicas until nothing moves.  Runs on the
    scheduler between sweeps."""
    for _ in range(_MAX_QUIESCE_ROUNDS):
        for rep in graph._all_replicas:
            if rep.emitter is not None and not rep.done:
                rep.emitter.flush(rep.current_wm)
        progressed = False
        for rep in graph._all_replicas:
            if rep.drain(0):
                progressed = True
        if not progressed:
            if any(rep.inbox for rep in graph._all_replicas):
                raise WindFlowError(
                    "durability barrier could not quiesce the graph: "
                    "a replica holds pending input but no replica "
                    "makes progress")
            return
    raise WindFlowError(
        "durability barrier exceeded the quiesce round bound — "
        "the graph keeps generating work without source ticks")


def keyed_emitters_into(graph, op):
    """Every override-capable keyed emitter feeding ``op``'s replicas
    (host KeyByEmitter and the keyed staging emitter)."""
    from windflow_tpu_torch.parallel.emitters import (DeviceToHostEmitter,
                                                      KeyByEmitter,
                                                      KeyedDeviceStageEmitter,
                                                      SplittingEmitter)
    dest_ids = {id(r) for r in op.replicas}
    out = []

    def visit(em):
        if em is None:
            return
        if isinstance(em, DeviceToHostEmitter):
            visit(em.inner)
            return
        if isinstance(em, SplittingEmitter):
            for b in em.branches:
                visit(b)
            return
        if isinstance(em, (KeyByEmitter, KeyedDeviceStageEmitter)) \
                and any(id(r) in dest_ids for r, _ in em.dests):
            out.append(em)

    for rep in graph._all_replicas:
        visit(rep.emitter)
    return out


def collect_overrides(graph) -> dict:
    """Per-operator merged key→shard override maps installed on the
    keyed emitters (the reshard executor's ``move_keys``) — the placement
    half of the manifest; empty while no key was moved."""
    out = {}
    for op in graph._operators:
        merged = {}
        for em in keyed_emitters_into(graph, op):
            ov = getattr(em, "_override", None)
            if ov:
                merged.update(ov)
        if merged:
            out[op.ordinal] = merged
    return out


def install_overrides(graph, overrides: dict) -> None:
    """Re-install recorded key→shard overrides onto a freshly built
    graph's keyed emitters, dropping moves that target shards beyond
    the new shard count (the rescale may have shrunk it)."""
    for op in graph._operators:
        ov = overrides.get(op.ordinal)
        if not ov:
            continue
        n = op.parallelism
        kept = {k: d for k, d in ov.items()
                if isinstance(d, int) and 0 <= d < n}
        if not kept:
            continue
        for em in keyed_emitters_into(graph, op):
            em.set_override(dict(kept))


class DurabilityPlane:
    """Per-graph checkpoint coordinator (built by ``PipeGraph._build``
    when ``Config.durability`` names a directory; ``None`` otherwise —
    the sweep loop's whole off-cost is that one check)."""

    def __init__(self, graph) -> None:
        from windflow_tpu_torch.persistent.kv import LogKV
        self.graph = graph
        # the sinks first: a refused composition opens no store
        self._bind_sinks()
        self.dir = graph.config.durability
        os.makedirs(self.dir, exist_ok=True)
        self.kv = LogKV(os.path.join(self.dir, "checkpoint.kv"))
        self._closed = False
        #: next epoch id to commit (continues past the restored epoch)
        self.epoch = 0
        self._sweeps = 0
        # counters surfaced via stats()["Durability"]
        self.epochs_committed = 0
        self.last_checkpoint_ms = None
        self.checkpoint_ms_total = 0.0
        self.last_checkpoint_bytes = 0
        self.checkpoint_bytes_total = 0
        #: the part of a checkpoint after the quiesce (the blobs, the
        #: manifest, the fsync): a checkpoint's own cost, where
        #: checkpoint_ms also counts draining the work in flight
        self.last_snapshot_ms = None
        self.snapshot_ms_total = 0.0
        self.restored_epoch = None
        self.restore_ms = None
        self.sink_commits = 0
        #: failure-injection hook (durability/chaos.py): called with a
        #: site name at checkpoint milestones; raising aborts the graph
        #: there.  None in production.
        self.chaos_hook = None

    def _bind_sinks(self) -> None:
        """Switch Kafka sink replicas to buffered exactly-once mode: the
        fence id scopes dedupe to (app, operator, replica) — two graphs
        sharing a broker must run under distinct app names.  Epoch-file
        sink functions (one shared object carrying commit_epoch) are
        rejected at parallelism > 1: every replica would share the same
        staging file handle."""
        from windflow_tpu_torch.kafka.kafka_sink import KafkaSinkReplica
        for op in self.graph._operators:
            if not op.is_terminal:
                continue
            if op.parallelism > 1 and getattr(
                    getattr(op, "fn", None), "commit_epoch", None):
                raise WindFlowError(
                    f"sink '{op.name}': an epoch-committing sink "
                    "function (EpochFileSink) is one shared object and "
                    "supports parallelism == 1 — build one Sink per "
                    "partition, each with its own sink directory")
            for rep in op.replicas:
                if isinstance(rep, KafkaSinkReplica):
                    rep._durable = True
                    rep._fence_id = (f"{self.graph.name}/"
                                     f"{op.name}/{rep.index}")

    # -- keys ----------------------------------------------------------------
    @staticmethod
    def _k_manifest(epoch: int) -> bytes:
        return b"ep/%d/manifest" % epoch

    @staticmethod
    def _k_op(epoch: int, ordinal: int) -> bytes:
        return b"ep/%d/op/%d" % (epoch, ordinal)

    @staticmethod
    def _k_reps(epoch: int) -> bytes:
        return b"ep/%d/reps" % epoch

    @staticmethod
    def _k_placements(epoch: int) -> bytes:
        return b"ep/%d/placements" % epoch

    # -- sweep hook ----------------------------------------------------------
    def on_sweep(self) -> None:
        """Called once per scheduler sweep (PipeGraph.step).  Counts toward
        the epoch cadence; everything expensive lives in checkpoint()."""
        self._chaos("sweep")
        self._sweeps += 1
        every = max(1, self.graph.config.durability_epoch_sweeps)
        if self._sweeps % every == 0 and not self.graph.is_done():
            self.checkpoint()

    def _chaos(self, site: str) -> None:
        if self.chaos_hook is not None:
            self.chaos_hook(site)

    # -- checkpoint ----------------------------------------------------------
    def checkpoint(self) -> int:
        """Run the full epoch protocol (module docstring steps 1-5).
        Returns the committed epoch id."""
        t0 = time.perf_counter()
        epoch = self.epoch
        self._chaos("pre_barrier")
        quiesce(self.graph)
        self._chaos("post_quiesce")
        self._commit_sinks(epoch)
        self._chaos("post_sink_commit")
        t_snap = time.perf_counter()
        nbytes = self._write_snapshots(epoch)
        from windflow_tpu_torch.durability.rebucket import mesh_shape
        manifest = {
            "schema": CHECKPOINT_SCHEMA,
            "app": self.graph.name,
            "epoch": epoch,
            "written_at_usec": current_time_usecs(),
            "topology": topology_signature(self.graph._operators),
            # the shard shape this epoch's keyed state was bucketed
            # under (None off a mesh)
            "mesh": mesh_shape(self.graph.config.mesh),
            "placements": {str(ordinal): len(ov) for ordinal, ov
                           in collect_overrides(self.graph).items()},
        }
        self.kv.put(self._k_manifest(epoch), json.dumps(manifest).encode())
        self.kv.flush()          # the commit point: manifest + fsync
        t_end = time.perf_counter()
        self._chaos("post_manifest")
        self.epoch = epoch + 1
        self.epochs_committed += 1
        self.last_snapshot_ms = (t_end - t_snap) * 1e3
        self.snapshot_ms_total += self.last_snapshot_ms
        ms = (t_end - t0) * 1e3
        self.last_checkpoint_ms = ms
        self.checkpoint_ms_total += ms
        self.last_checkpoint_bytes = nbytes
        self.checkpoint_bytes_total += nbytes
        self._gc(epoch)
        return epoch

    def _sink_commit_hooks(self):
        """(replica, hook) pairs for every terminal replica exposing an
        epoch commit: durability-aware Kafka sink replicas, and plain
        Sink functions wrapping an EpochFileSink-style object."""
        out = []
        for op in self.graph._operators:
            if not op.is_terminal:
                continue
            for rep in op.replicas:
                hook = getattr(rep, "commit_epoch", None)
                if hook is None:
                    hook = getattr(getattr(op, "fn", None),
                                   "commit_epoch", None)
                if hook is not None:
                    out.append((rep, hook))
        return out

    def _commit_sinks(self, epoch: int) -> None:
        for _, hook in self._sink_commit_hooks():
            hook(epoch)
            self.sink_commits += 1

    def _write_snapshots(self, epoch: int) -> int:
        g = self.graph
        nbytes = 0
        for op in g._operators:
            blob = op.snapshot_state()
            if blob is None:
                continue
            try:
                raw = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as e:  # lint: broad-except-ok (re-raised
                # with the operator named: pickling arbitrary user state
                # fails in many exception types)
                raise WindFlowError(
                    f"checkpoint epoch {epoch}: state of operator "
                    f"'{op.name}' ({type(op).__name__}) is not "
                    f"picklable ({type(e).__name__}: {e}) — keep "
                    "checkpointed per-key state to plain "
                    "data (numbers, strings, dicts, numpy)") from e
            self.kv.put(self._k_op(epoch, op.ordinal), raw)
            nbytes += len(raw)
        raw = pickle.dumps(self._replica_records(),
                           protocol=pickle.HIGHEST_PROTOCOL)
        self.kv.put(self._k_reps(epoch), raw)
        nbytes += len(raw)
        overrides = collect_overrides(self.graph)
        if overrides:
            raw = pickle.dumps(overrides,
                               protocol=pickle.HIGHEST_PROTOCOL)
            self.kv.put(self._k_placements(epoch), raw)
            nbytes += len(raw)
        return nbytes

    def _replica_records(self) -> list:
        """Per-replica host bookkeeping: watermark frontiers, source
        timestamp/origin-id sequencing, Kafka consumer offsets, sink
        fence sequence numbers."""
        from windflow_tpu_torch.ops.source import BaseSourceReplica
        out = []
        for op in self.graph._operators:
            for rep in op.replicas:
                d = {"ordinal": op.ordinal, "index": rep.index,
                     "wm": rep.current_wm, "hooked_wm": rep._hooked_wm}
                if isinstance(rep, BaseSourceReplica):
                    d["last_ts"] = rep._last_ts
                    d["tid_seq"] = rep._tid_seq
                    d["since_punct"] = rep._since_punct
                d.update(self._kafka_record(rep))
                out.append(d)
        return out

    @staticmethod
    def _kafka_record(rep) -> dict:
        from windflow_tpu_torch.kafka.kafka_sink import KafkaSinkReplica
        from windflow_tpu_torch.kafka.kafka_source import KafkaSourceReplica
        if isinstance(rep, KafkaSourceReplica):
            pos = None
            if rep._consumer is not None:
                pos = rep._consumer.positions()
            return {"kafka_positions": pos,
                    "part_max": dict(rep._part_max)}
        if isinstance(rep, KafkaSinkReplica):
            return {"sink_seq": rep._seq, "sink_epoch": rep._epoch}
        return {}

    def _gc(self, committed: int) -> None:
        keep = max(1, self.graph.config.durability_keep)
        drop_before = committed - keep + 1
        if drop_before <= 0:
            return
        for key in self.kv.keys():
            try:
                if not key.startswith(b"ep/"):
                    continue
                ep = int(key.split(b"/", 2)[1])
            except (ValueError, IndexError):
                continue
            if ep < drop_before:
                self.kv.delete(key)

    # -- restore (the plane side; entry point is restore_graph below) --------
    def apply_restore(self, pending: dict) -> None:
        """Apply stashed checkpoint state to a just-built graph — called
        by ``PipeGraph.start()`` after ``_build()`` (replicas, fusion
        preludes and the megastep plane exist) and before the first
        source tick.  On a rescale every keyed blob is re-bucketed first
        (durability/rebucket.py), so state lands exactly where the new
        placement will route its keys."""
        t0 = time.perf_counter()
        g = self.graph
        epoch = pending["epoch"]
        from windflow_tpu_torch.durability.rebucket import (mesh_shape,
                                                            rebucket_blob)
        topo = pending["manifest"].get("topology") or []
        old_mesh = pending["manifest"].get("mesh")
        new_mesh = mesh_shape(g.config.mesh)
        placements = pending.get("placements") or {}
        rescaled = pending.get("rescaled", False)
        if placements:
            install_overrides(g, placements)
        for ordinal, blob in pending["ops"].items():
            op = g._operators[ordinal]
            old_p = topo[ordinal]["parallelism"] \
                if ordinal < len(topo) else op.parallelism
            blob = rebucket_blob(op, blob, old_p, op.parallelism,
                                 old_mesh, new_mesh,
                                 override=placements.get(ordinal))
            op.restore_state(blob)
        by_key = {(r["ordinal"], r["index"]): r for r in pending["reps"]}
        merged = self._merged_records(pending["reps"])
        from windflow_tpu_torch.ops.source import BaseSourceReplica
        for op in g._operators:
            for rep in op.replicas:
                r = by_key.get((op.ordinal, rep.index))
                if r is None:
                    # rescale grew this operator: the new replica has no
                    # per-replica record — seed from the op's merged
                    # record (min watermark = conservative frontier)
                    r = merged.get(op.ordinal)
                    if r is None:
                        continue
                rep.current_wm = r["wm"]
                rep._hooked_wm = r.get("hooked_wm", r["wm"])
                if isinstance(rep, BaseSourceReplica):
                    rep._last_ts = r["last_ts"]
                    rep._tid_seq = r["tid_seq"]
                    rep._since_punct = r["since_punct"]
                self._apply_kafka(rep, r)
        for _, hook in self._sink_restore_hooks():
            hook(epoch)
        if rescaled:
            self._check_fences_reconciled(epoch)
        self.epoch = epoch + 1
        self.restored_epoch = epoch
        self.restore_ms = (time.perf_counter() - t0) * 1e3 \
            + pending.get("load_ms", 0.0)

    @staticmethod
    def _merged_records(reps: list) -> dict:
        """Per-ordinal fold of the replica records, for replicas a
        rescale added: minimum watermark (never fires a window the old
        shards had not), maximum source sequencing."""
        out = {}
        for r in reps:
            m = out.get(r["ordinal"])
            if m is None:
                m = out[r["ordinal"]] = dict(r)
                # group-level Kafka state reseeds through the op-level
                # stash (_apply_kafka) from EVERY old record already;
                # the merged record must not re-apply one replica's
                del m["index"]
                continue
            m["wm"] = min(m["wm"], r["wm"])
            if "hooked_wm" in m and "hooked_wm" in r:
                m["hooked_wm"] = min(m["hooked_wm"], r["hooked_wm"])
            for k in ("last_ts", "tid_seq", "since_punct"):
                if k in r and k in m:
                    m[k] = max(m[k], r[k])
        return out

    def _check_fences_reconciled(self, restored_epoch: int) -> None:
        """Rescale fence guard: the broker fence dedupes on the
        replica-LIFETIME message sequence, which stays exact across a
        replay only while the replayed record ORDER matches the
        committed one — true on the checkpointed shard shape, not across
        a rescale.  If a sink fence sits AHEAD of the restored manifest
        (the mid-sink-flush torn window), a rescaled replay would dedupe
        by position against records it regenerates in a different order
        — refuse, and name the fix."""
        from windflow_tpu_torch.kafka.kafka_sink import KafkaSinkReplica
        for op in self.graph._operators:
            if not op.is_terminal:
                continue
            for rep in op.replicas:
                if not isinstance(rep, KafkaSinkReplica) \
                        or not rep._durable:
                    continue
                fence_fn = getattr(
                    getattr(rep._producer, "_broker", None), "fence",
                    None)
                if fence_fn is None:
                    continue
                f = fence_fn(rep._fence_id)
                if f is not None and f[0] > restored_epoch:
                    raise WindFlowError(
                        f"WF605 restore: sink '{op.name}' replica "
                        f"{rep.index} committed epoch {f[0]} through its "
                        f"fence but the last complete manifest is epoch "
                        f"{restored_epoch} (a crash in the torn "
                        "two-phase window) — a shard-shape-changing "
                        "replay re-interleaves records and the fence's "
                        "sequence dedupe would drop the wrong ones. "
                        "Restore once on the checkpointed shape to "
                        "reconcile the torn epoch, checkpoint, then "
                        "rescale")

    @staticmethod
    def _apply_kafka(rep, r: dict) -> None:
        from windflow_tpu_torch.kafka.kafka_sink import KafkaSinkReplica
        from windflow_tpu_torch.kafka.kafka_source import KafkaSourceReplica
        if isinstance(rep, KafkaSourceReplica):
            # per-partition event-time frontiers and consumer positions
            # are GROUP-level: the post-restart rebalance may hand a
            # partition to another replica index, so every replica seeds
            # from the merged maps at rep.start() (the consumer does not
            # exist yet) and its first poll prunes to its own assignment
            if r.get("part_max"):
                cur = getattr(rep.op, "_restore_part_max", None) or {}
                cur.update(r["part_max"])
                rep.op._restore_part_max = cur
            if r.get("kafka_positions"):
                cur = getattr(rep.op, "_restore_positions", None) or {}
                cur.update(r["kafka_positions"])
                rep.op._restore_positions = cur
        elif isinstance(rep, KafkaSinkReplica):
            rep._seq = r.get("sink_seq", 0)
            rep._epoch = r.get("sink_epoch", 0)

    def _sink_restore_hooks(self):
        out = []
        for op in self.graph._operators:
            if not op.is_terminal:
                continue
            for rep in op.replicas:
                hook = getattr(rep, "on_restore", None)
                if hook is None:
                    hook = getattr(getattr(op, "fn", None),
                                   "on_restore", None)
                if hook is not None:
                    out.append((rep, hook))
        return out

    # -- read surface --------------------------------------------------------
    def section(self) -> dict:
        """The ``stats()["Durability"]`` payload."""
        dedupe = 0
        for op in self.graph._operators:
            for rep in op.replicas:
                dedupe += getattr(rep, "_dedupe_hits", 0)
        return {
            "enabled": True,
            "dir": self.dir,
            "epoch": self.epoch,
            "epochs_committed": self.epochs_committed,
            "last_checkpoint_ms": self.last_checkpoint_ms,
            "checkpoint_ms_total": self.checkpoint_ms_total,
            "last_checkpoint_bytes": self.last_checkpoint_bytes,
            "checkpoint_bytes_total": self.checkpoint_bytes_total,
            "last_snapshot_ms": self.last_snapshot_ms,
            "snapshot_ms_total": self.snapshot_ms_total,
            "restored_epoch": self.restored_epoch,
            "restore_ms": self.restore_ms,
            "sink_commits": self.sink_commits,
            "dedupe_hits": dedupe,
        }

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.kv.flush()
            self.kv.close()


# ---------------------------------------------------------------------------
# restore entry point (PipeGraph.restore delegates here)
# ---------------------------------------------------------------------------

def last_complete_epoch(kv) -> Optional[int]:
    """Largest epoch with a manifest in the store — the commit marker
    whose presence the torn-tail truncation guarantees is trustworthy."""
    best = None
    for key in kv.keys():
        if key.startswith(b"ep/") and key.endswith(b"/manifest"):
            try:
                ep = int(key.split(b"/", 2)[1])
            except (ValueError, IndexError):
                continue
            if best is None or ep > best:
                best = ep
    return best


def load_checkpoint(ckpt_dir: str) -> dict:
    """Read the last complete epoch's manifest + blobs from a checkpoint
    directory (opens and closes its own KV handle — the plane reopens
    the store when the restored graph builds)."""
    from windflow_tpu_torch.persistent.kv import LogKV
    path = os.path.join(ckpt_dir, "checkpoint.kv")
    if not os.path.exists(path):
        raise WindFlowError(
            f"no checkpoint store at {path!r} — nothing to restore")
    t0 = time.perf_counter()
    kv = LogKV(path)
    try:
        epoch = last_complete_epoch(kv)
        if epoch is None:
            raise WindFlowError(
                f"checkpoint store {path!r} holds no complete epoch "
                "(no manifest survived) — nothing to restore")
        manifest = json.loads(kv.get(b"ep/%d/manifest" % epoch))
        if manifest.get("schema") != CHECKPOINT_SCHEMA:
            raise WindFlowError(
                f"unknown checkpoint schema {manifest.get('schema')!r} "
                f"(want {CHECKPOINT_SCHEMA!r})")
        ops = {}
        prefix = b"ep/%d/op/" % epoch
        for key in kv.keys():
            if key.startswith(prefix):
                ops[int(key[len(prefix):])] = pickle.loads(kv.get(key))
        reps = pickle.loads(kv.get(b"ep/%d/reps" % epoch))
        raw = kv.get(b"ep/%d/placements" % epoch)
        placements = pickle.loads(raw) if raw is not None else {}
    finally:
        kv.close()
    return {"epoch": epoch, "manifest": manifest, "ops": ops,
            "reps": reps, "placements": placements,
            "load_ms": (time.perf_counter() - t0) * 1e3}


def restore_graph(graph, ckpt_dir: Optional[str] = None):
    """Rebuild a composed-but-unstarted PipeGraph at the last complete
    checkpoint epoch: validate the manifest's topology signature (WF602
    named diff on mismatch), stash the state blobs, start the graph, and
    let the plane apply them before the first source tick.  Kafka
    sources resume from the checkpointed per-partition offsets; sinks
    resume fenced, so replayed output dedupes.  Returns the graph,
    started — drive it with ``wait_end()`` / ``step()``."""
    if graph._started:
        raise WindFlowError("restore() must run on an unstarted graph")
    d = ckpt_dir or graph.config.durability
    if not d:
        raise WindFlowError(
            "restore() needs a checkpoint directory (argument or "
            "Config.durability)")
    if graph.config.durability != d:
        # the rebuilt plane must reopen THIS store — but PipeGraph holds
        # a passed Config by reference, so change a private copy:
        # writing through would enable durability (on OUR store, with
        # fence collisions) for every other graph sharing the Config
        import dataclasses
        graph.config = dataclasses.replace(graph.config, durability=d)
    pending = load_checkpoint(d)
    from windflow_tpu_torch.analysis.preflight import manifest_rescale_plan
    diags, rescaled = manifest_rescale_plan(graph, pending["manifest"])
    if diags:
        lines = "\n  ".join(str(dg) for dg in diags)
        raise WindFlowError(
            f"restore: graph does not match checkpoint epoch "
            f"{pending['epoch']} of app "
            f"{pending['manifest'].get('app')!r}:\n  {lines}")
    pending["rescaled"] = rescaled
    graph._pending_restore = pending
    graph.start()
    return graph
