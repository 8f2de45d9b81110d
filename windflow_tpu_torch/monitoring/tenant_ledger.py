"""Tenant plane: per-tenant attribution across every PipeGraph in the
process (the port of ``windflow_tpu/monitoring/tenant_ledger.py``).

A process-level :class:`TenantLedger` that every built graph joins
(``Config.tenant``, default the graph's name) attributes, at cadence and
with no work on the batch path:

- **dispatches** from the per-operator step watches (the sweep ledger's
  baseline-and-diff, so two graphs reusing an op name never cross-credit);
- **capture wall-ms** from the step registry (the JAX package's
  compile-ms column: in the port a "compile" is a CUDA graph capture),
  diffed against a per-graph baseline by op name;
- **H2D/D2H wire and logical bytes** from the per-replica transfer
  counters, the ones ``stats()["Bytes_H2D_total"]`` sums, so a tenant's
  bytes sum to its graphs' totals by construction;
- **resident device bytes** from a depth-limited walk of each operator's
  and replica's instance dict for tensors on the graph's device, each
  storage counted once (``untyped_storage().data_ptr()``: a view and the
  tensor it views, or a megastep's static buffers and their users, are
  one allocation) — the budget basis; it reads tensor metadata only;
- the modeled **ICI bytes** from the shard plane and the tenant's
  **latency share** from the latency plane.

``Config.hbm_budget_bytes`` declares a per-tenant budget: ``ENTER_AFTER``
consecutive over-budget ticks latch ``OVER_BUDGET`` on the tenant's
heaviest operator (held while over, cleared after ``CLEAR_AFTER``
consecutive under-budget ticks, ``last_verdict`` kept for postmortems).

The section feeds ``stats()["Tenant"]``, the ``wf_tenant_*`` OpenMetrics
families, the postmortem's ``tenant.json``, ``analysis/tenancy.py`` and
``tools/wf_tenant.py``.  Off (``Config.tenant_ledger``) the graph never
registers: each call site keeps one ``is not None`` check.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

#: consecutive over-budget ticks before OVER_BUDGET enters
ENTER_AFTER = 2
#: consecutive under-budget ticks before an active verdict clears
CLEAR_AFTER = 3

#: recursion depth of the resident-bytes walk (operator dict → container
#: → state object dict → tensor covers every operator)
_WALK_DEPTH = 4


def _resident_state_bytes(objs, device,
                          per_obj: Optional[dict] = None) -> int:
    """Bytes of the tensor storages on ``device``'s type reachable from
    the instance dicts of ``objs`` (operators and replicas), each storage
    counted once.  The walk recurses plain containers and instance dicts
    to a fixed depth and never triggers a property; it reads metadata
    only (no device access)."""
    import torch
    dev_type = getattr(device, "type", device)
    #: id -> the remaining depth the node was last visited with: a node
    #: first reached through a long path is revisited by a shorter one
    seen: Dict[int, int] = {}
    counted = set()     # (device type, storage pointer)
    total = 0

    def walk(v, depth: int) -> int:
        nonlocal total
        if isinstance(v, (str, bytes, int, float, bool, type(None))):
            return 0
        if isinstance(v, torch.Tensor):
            if v.device.type != dev_type or v.is_sparse:
                return 0
            try:
                st = v.untyped_storage()
                key = (st.device.type, st.data_ptr())
                nbytes = int(st.nbytes())
            except Exception:  # lint: broad-except-ok (an exotic tensor (no
                # storage) must not take telemetry down)
                return 0
            if nbytes == 0 or key in counted:
                return 0
            counted.add(key)
            total += nbytes
            return nbytes
        i = id(v)
        if seen.get(i, -1) >= depth:
            return 0
        seen[i] = depth
        if depth <= 0:
            return 0
        got = 0
        if isinstance(v, dict):
            for x in list(v.values()):
                got += walk(x, depth - 1)
        elif isinstance(v, (list, tuple, set, frozenset, deque)):
            for x in list(v):
                got += walk(x, depth - 1)
        else:
            d = getattr(v, "__dict__", None)
            if isinstance(d, dict):
                for x in list(d.values()):
                    got += walk(x, depth - 1)
        return got

    for o in objs:
        d = getattr(o, "__dict__", None)
        if not isinstance(d, dict):
            continue
        got = 0
        for v in list(d.values()):
            got += walk(v, _WALK_DEPTH)
        if per_obj is not None:
            name = getattr(o, "name", None)
            if name is not None:
                per_obj[name] = per_obj.get(name, 0) + got
    return total


class _TenantTrack:
    """Per-tenant budget state machine: ``ENTER_AFTER`` consecutive over
    ticks enter, the verdict latches, ``CLEAR_AFTER`` OK ticks clear."""

    __slots__ = ("tenant", "budget_bytes", "active", "entered", "cleared",
                 "verdict", "last_verdict", "_over_ticks", "_ok_ticks")

    def __init__(self, tenant: str, budget_bytes: int) -> None:
        self.tenant = tenant
        self.budget_bytes = int(budget_bytes)
        self.active = False
        self.entered = 0
        self.cleared = 0
        self.verdict: Optional[dict] = None
        self.last_verdict: Optional[dict] = None
        self._over_ticks = 0
        self._ok_ticks = 0

    def tick(self, hbm_bytes: int, graph: Optional[str],
             heaviest_op: Optional[str]) -> None:
        if self.budget_bytes <= 0:
            return
        if hbm_bytes > self.budget_bytes:
            self._over_ticks += 1
            self._ok_ticks = 0
            if self.active or self._over_ticks >= ENTER_AFTER:
                if not self.active:
                    self.active = True
                    self.entered += 1
                over = int(hbm_bytes - self.budget_bytes)
                self.verdict = {
                    "state": "OVER_BUDGET",
                    "tenant": self.tenant,
                    "hbm_bytes": int(hbm_bytes),
                    "budget_bytes": self.budget_bytes,
                    "overage_bytes": over,
                    "graph": graph,
                    "heaviest_op": heaviest_op,
                    "message": (
                        f"tenant '{self.tenant}' holds {int(hbm_bytes)} B "
                        f"resident device state against an HBM budget of "
                        f"{self.budget_bytes} B (+{over} B); heaviest op: "
                        f"{heaviest_op} (graph {graph}) — see "
                        "tools/wf_tenant.py for the shed plan"),
                }
                self.last_verdict = self.verdict
        else:
            self._over_ticks = 0
            if self.active:
                self._ok_ticks += 1
                if self._ok_ticks >= CLEAR_AFTER:
                    self.active = False
                    self.cleared += 1
                    self.verdict = None
                    self._ok_ticks = 0

    def budget_json(self, hbm_bytes: int) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "hbm_bytes": int(hbm_bytes),
            "pressure": (round(hbm_bytes / self.budget_bytes, 4)
                         if self.budget_bytes > 0 else None),
            "active": self.active,
            "entered": self.entered,
            "cleared": self.cleared,
            "verdict": self.verdict,
            "last_verdict": self.last_verdict,
        }


class _GraphEntry:
    """One registered graph: a weakref and the attribution baselines
    taken at register (per-watch dispatches, per-name capture ms)."""

    __slots__ = ("ref", "name", "tenant", "wbase", "cbase", "frozen")

    def __init__(self, graph, tenant: str) -> None:
        from windflow_tpu_torch.monitoring.jit_registry import \
            default_registry
        from windflow_tpu_torch.monitoring.sweep_ledger import _op_wrappers
        self.ref = weakref.ref(graph)
        self.name = graph.name
        self.tenant = tenant
        self.wbase: Dict[int, int] = {
            id(w): w.dispatches for op in graph._operators
            for w in _op_wrappers(op)}
        self.cbase: Dict[str, float] = {
            name: e["compile_ms_total"]
            for name, e in default_registry().snapshot().items()}
        #: the final attribution, frozen at the graph's teardown
        self.frozen: Optional[dict] = None

    def collect(self) -> Optional[dict]:
        """The graph's attribution row: frozen after teardown, live
        before, None once the graph is gone unfrozen."""
        g = self.ref()
        if g is None or self.frozen is not None:
            return self.frozen
        from windflow_tpu_torch.monitoring.jit_registry import \
            default_registry
        from windflow_tpu_torch.monitoring.sweep_ledger import _op_wrappers
        per_op: Dict[str, dict] = {}
        dispatches = 0
        for op in g._operators:
            n = sum(w.dispatches - self.wbase.get(id(w), 0)
                    for w in _op_wrappers(op))
            per_op[op.name] = {"dispatches": n}
            dispatches += n
        # capture wall-ms: the registry's per-name table diffed against
        # the register baseline (two graphs sharing an op name split it
        # ambiguously, as in the JAX package)
        compile_ms = 0.0
        snap = default_registry().snapshot()
        for op in g._operators:
            ms = 0.0
            for name, e in snap.items():
                if name == op.name or name.startswith(op.name + "."):
                    ms += e["compile_ms_total"] - self.cbase.get(name, 0.0)
            if ms > 0:
                per_op[op.name]["compile_ms"] = round(ms, 3)
                compile_ms += ms
        per_obj: Dict[str, int] = {}
        resident = _resident_state_bytes(
            list(g._operators) + list(g._all_replicas),
            g.device if g.device is not None else "cpu", per_obj)
        for name, b in per_obj.items():
            if name in per_op:
                per_op[name]["resident_bytes"] = b
        heaviest = None
        if per_op:
            heaviest = max(
                per_op,
                key=lambda n: (per_op[n].get("resident_bytes", 0),
                               per_op[n]["dispatches"]))
        reps = g._all_replicas
        row = {
            "graph": g.name,
            "tenant": self.tenant,
            "dispatches": dispatches,
            "compile_ms": round(compile_ms, 3),
            "h2d_bytes": sum(r.stats.h2d_bytes for r in reps),
            "h2d_logical_bytes": sum(r.stats.h2d_logical_bytes
                                     for r in reps),
            "d2h_bytes": sum(r.stats.d2h_bytes for r in reps),
            "resident_state_bytes": resident,
            "per_op": per_op,
            "heaviest_op": heaviest,
        }
        if g._shard is not None:
            # the model's host constants, not the section: its sketch
            # reads would put device reads on the tick
            row.update(g._shard.ici_totals())
        if g._latency is not None:
            row["latency_usec_total"] = round(
                sum(g._latency.segment_totals.values()), 3)
        return row


class TenantLedger:
    """The process-level tenant registry (:func:`default_ledger`): every
    graph built with ``Config.tenant_ledger`` on registers at build and
    freezes its attribution at teardown."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._graphs: Dict[int, _GraphEntry] = {}   # id(graph) -> entry
        self._tracks: Dict[str, _TenantTrack] = {}  # tenant -> track
        #: the process staged-bytes baseline of the attributed fraction
        #: (staging.device_bytes is cumulative over every graph)
        self._staged_base = self._snap_staged()
        self.collects = 0
        self.collect_ms_total = 0.0
        self.last_collect_ms = 0.0
        #: a tenant's budget machine ticks at most this often, however
        #: many graphs (or stats loops) drive it
        self.tick_min_interval_s = 0.25
        self._last_tick: Dict[str, float] = {}

    @staticmethod
    def _snap_staged() -> dict:
        from windflow_tpu_torch import staging
        db = staging.device_bytes
        return {"staged_bytes_total": db.staged_bytes_total,
                "logical_bytes_total": db.logical_bytes_total,
                "staged_batches_total": db.staged_batches_total}

    # -- registration --------------------------------------------------------
    def register(self, graph, tenant: str,
                 budget_bytes: int = 0) -> "GraphTenantHandle":
        with self._lock:
            if not self._graphs:
                # a new accounting epoch: earlier graphs do not dilute
                # the attributed fraction
                self._staged_base = self._snap_staged()
            self._graphs[id(graph)] = _GraphEntry(graph, tenant)
            track = self._tracks.get(tenant)
            if track is None:
                track = self._tracks[tenant] = _TenantTrack(
                    tenant, budget_bytes)
            elif budget_bytes and not track.budget_bytes:
                track.budget_bytes = int(budget_bytes)
            return GraphTenantHandle(self, graph, tenant)

    def freeze(self, graph) -> None:
        """Keep the graph's final attribution (``PipeGraph._finalize``),
        so the tenant roll-up survives its replicas."""
        with self._lock:
            entry = self._graphs.get(id(graph))
        if entry is None or entry.frozen is not None:
            return
        try:
            frozen = entry.collect()
        except Exception:  # lint: broad-except-ok (teardown telemetry)
            frozen = None
        with self._lock:
            if frozen is not None:
                entry.frozen = frozen

    def reset(self) -> None:
        """Drop every registration and re-anchor the baselines."""
        with self._lock:
            self._graphs.clear()
            self._tracks.clear()
            self._staged_base = self._snap_staged()
            self.collects = 0
            self.collect_ms_total = 0.0
            self.last_collect_ms = 0.0

    # -- collection ----------------------------------------------------------
    def _collect_rows(self) -> List[dict]:
        with self._lock:
            entries = list(self._graphs.values())
        rows = []
        for e in entries:
            try:
                row = e.collect()
            except Exception as ex:  # lint: broad-except-ok (one broken graph
                # must not hide every other tenant)
                row = {"graph": e.name, "tenant": e.tenant,
                       "error": f"{type(ex).__name__}: {ex}"[:200]}
            if row is not None:
                rows.append(row)
        return rows

    def tick(self, tenant: Optional[str] = None,
             force: bool = False) -> None:
        """Advance the budget machine(s) from a fresh collection
        (``PipeGraph.health_tick`` cadence, throttled per tenant by
        ``tick_min_interval_s``; ``force`` bypasses)."""
        now_s = time.monotonic()
        names = [tenant] if tenant is not None else list(self._tracks)
        if not force and all(now_s - self._last_tick.get(n, 0.0)
                             < self.tick_min_interval_s for n in names):
            return
        with self._lock:
            for n in names:
                self._last_tick[n] = now_s
        t0 = time.perf_counter()
        by_tenant: Dict[str, List[dict]] = {}
        for r in self._collect_rows():
            by_tenant.setdefault(r["tenant"], []).append(r)
        with self._lock:
            tracks = dict(self._tracks)
        for name, track in tracks.items():
            if tenant is not None and name != tenant:
                continue
            trows = by_tenant.get(name, [])
            hbm = sum(r.get("resident_state_bytes", 0) for r in trows)
            graph, heaviest, best = None, None, -1
            for r in trows:
                h = r.get("heaviest_op")
                if h is None:
                    continue
                score = (r.get("per_op") or {}).get(h, {}) \
                    .get("resident_bytes", 0)
                if score > best:
                    best, graph, heaviest = score, r["graph"], h
            track.tick(hbm, graph, heaviest)
        dt = (time.perf_counter() - t0) * 1000.0
        self.collects += 1
        self.collect_ms_total += dt
        self.last_collect_ms = dt

    def verdict_for(self, graph_name: str) -> Optional[dict]:
        """The active OVER_BUDGET verdict whose heaviest op lives in
        ``graph_name`` (only that graph paints it)."""
        with self._lock:
            tracks = list(self._tracks.values())
        for t in tracks:
            v = t.verdict
            if t.active and v is not None and v.get("graph") == graph_name:
                return v
        return None

    # -- export --------------------------------------------------------------
    def section(self, focus_graph: Optional[str] = None,
                focus_tenant: Optional[str] = None) -> dict:
        """The ``stats()["Tenant"]`` payload: the whole process table,
        from every graph (one dump is enough to plan across tenants)."""
        t0 = time.perf_counter()
        rows = self._collect_rows()
        by_tenant: Dict[str, List[dict]] = {}
        for r in rows:
            by_tenant.setdefault(r["tenant"], []).append(r)
        total_latency = sum(r.get("latency_usec_total", 0.0) for r in rows)
        tenants: Dict[str, dict] = {}
        with self._lock:
            tracks = dict(self._tracks)
        for name in sorted(by_tenant):
            trows = by_tenant[name]
            agg = {
                "graphs": sorted(r["graph"] for r in trows),
                "dispatches": sum(r.get("dispatches", 0) for r in trows),
                "compile_ms": round(sum(r.get("compile_ms", 0.0)
                                        for r in trows), 3),
                "h2d_bytes": sum(r.get("h2d_bytes", 0) for r in trows),
                "h2d_logical_bytes": sum(r.get("h2d_logical_bytes", 0)
                                         for r in trows),
                "d2h_bytes": sum(r.get("d2h_bytes", 0) for r in trows),
                "resident_state_bytes": sum(
                    r.get("resident_state_bytes", 0) for r in trows),
                "ici_bytes_per_tuple": round(
                    sum(r.get("ici_bytes_per_tuple", 0.0)
                        for r in trows), 2),
                "ici_provenance": next(
                    (r["ici_provenance"] for r in trows
                     if "ici_provenance" in r), None),
                "latency_usec_total": round(
                    sum(r.get("latency_usec_total", 0.0)
                        for r in trows), 3),
            }
            agg["latency_share"] = (
                round(agg["latency_usec_total"] / total_latency, 4)
                if total_latency > 0 else None)
            per_op: Dict[str, dict] = {}
            for r in trows:
                for op, d in (r.get("per_op") or {}).items():
                    cur = per_op.setdefault(
                        op, {"dispatches": 0, "graph": r["graph"]})
                    cur["dispatches"] += d.get("dispatches", 0)
                    if "resident_bytes" in d:
                        cur["resident_bytes"] = (
                            cur.get("resident_bytes", 0)
                            + d["resident_bytes"])
                    if "compile_ms" in d:
                        cur["compile_ms"] = round(
                            cur.get("compile_ms", 0.0) + d["compile_ms"],
                            3)
            agg["per_op"] = per_op
            agg["heaviest_op"] = (max(
                per_op, key=lambda n: (per_op[n].get("resident_bytes", 0),
                                       per_op[n]["dispatches"]))
                if per_op else None)
            track = tracks.get(name)
            if track is not None:
                agg["budget"] = track.budget_json(
                    agg["resident_state_bytes"])
            tenants[name] = agg
        # reconciliation: the tenants' staged bytes over the process's
        # staged-transfer delta since the baseline
        process_delta = (self._snap_staged()["staged_bytes_total"]
                         - self._staged_base["staged_bytes_total"])
        tenants_total = sum(t["h2d_bytes"] for t in tenants.values())
        dt = (time.perf_counter() - t0) * 1000.0
        self.collect_ms_total += dt
        self.last_collect_ms = dt
        out = {
            "enabled": True,
            "tenants": tenants,
            "attributed": {
                "staged_bytes_tenants_total": tenants_total,
                "staged_bytes_process_total": process_delta,
                "staged_fraction": (
                    round(tenants_total / process_delta, 4)
                    if process_delta > 0 else None),
            },
            "overhead": {
                "collects": self.collects,
                "collect_ms_total": round(self.collect_ms_total, 3),
                "last_collect_ms": round(self.last_collect_ms, 3),
            },
        }
        if focus_graph is not None:
            for r in rows:
                if r["graph"] == focus_graph:
                    out["graph"] = r
                    break
        if focus_tenant is not None:
            out["tenant"] = focus_tenant
        return out


class GraphTenantHandle:
    """One graph's view of the shared ledger (``PipeGraph._tenant``)."""

    __slots__ = ("ledger", "tenant", "_graph_name", "_graph_ref")

    def __init__(self, ledger: TenantLedger, graph, tenant: str) -> None:
        self.ledger = ledger
        self.tenant = tenant
        self._graph_name = graph.name
        self._graph_ref = weakref.ref(graph)

    def tick(self) -> None:
        """Advance this tenant's budget machine (health_tick cadence)."""
        self.ledger.tick(self.tenant)

    def health_verdict(self) -> Optional[dict]:
        """The active OVER_BUDGET verdict iff its heaviest op lives in
        this graph."""
        return self.ledger.verdict_for(self._graph_name)

    def section(self) -> dict:
        return self.ledger.section(focus_graph=self._graph_name,
                                   focus_tenant=self.tenant)

    def freeze(self) -> None:
        """Freeze this graph's final attribution (teardown)."""
        g = self._graph_ref()
        if g is not None:
            self.ledger.freeze(g)


_default_ledger: Optional[TenantLedger] = None
_default_lock = threading.Lock()


def default_ledger() -> TenantLedger:
    """The process-wide tenant ledger every graph registers in."""
    global _default_ledger
    with _default_lock:
        if _default_ledger is None:
            _default_ledger = TenantLedger()
        return _default_ledger
