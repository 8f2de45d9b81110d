"""Tenant scheduler: consume the tenancy advisor's plan (the port of
``windflow_tpu/serving/tenant_scheduler.py``).

The tenant ledger measures (``monitoring/tenant_ledger.py``), the tenancy
advisor plans (``analysis/tenancy.py``), and this scheduler is the
executor-facing half of that contract, pinned so the advisor's output
shape is load-bearing before an executor acts on it:

* :meth:`TenantScheduler.ingest` accepts exactly what
  ``analysis.tenancy.plan(...)`` returns (``advisor: "tenancy/1"``),
  validates every action against :data:`ACTION_KINDS` and the fields
  each kind promises, and queues them per tenant.  A malformed plan is
  rejected loudly (``ValueError``): contract drift shows at ingest, not
  at apply time.
* :meth:`TenantScheduler.pending` / :meth:`TenantScheduler.section`
  expose the queue.
* :meth:`TenantScheduler.apply_next` is the executor seam: it pops the
  next action and records it on a bounded timeline with ``applied:
  False``.  ``throttle_admission`` maps onto the reshard executor's
  admission machinery, ``drain_shards`` onto its move path,
  ``rescale_tenant`` onto the rescale restore and
  ``rebalance_hot_tenant`` onto a placement change.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

#: the advisor revision this scheduler consumes (tenancy.plan "advisor")
PLAN_SCHEMA = "tenancy/1"

#: action kind -> the fields analysis.tenancy._actions promises for it
ACTION_KINDS = {
    "throttle_admission": ("factor",),
    "rescale_tenant": ("shed_bytes",),
    "drain_shards": ("op",),
    "rebalance_hot_tenant": ("latency_share",),
}

_TIMELINE_CAP = 64


class TenantScheduler:
    """Process-scoped consumer of tenancy plans."""

    def __init__(self) -> None:
        self._queue: deque = deque()
        self.plans_ingested = 0
        self.actions_queued = 0
        self.rejected_plans = 0
        self.timeline: deque = deque(maxlen=_TIMELINE_CAP)

    # -- contract ------------------------------------------------------------
    def ingest(self, plan: dict) -> int:
        """Validate and queue one advisor plan; returns the actions
        queued.  Raises ``ValueError`` on contract drift."""
        if not isinstance(plan, dict) \
                or plan.get("advisor") != PLAN_SCHEMA:
            self.rejected_plans += 1
            raise ValueError(
                f"not a {PLAN_SCHEMA} plan: advisor="
                f"{plan.get('advisor') if isinstance(plan, dict) else plan!r}")
        tenants = plan.get("tenants")
        if not isinstance(tenants, list):
            self.rejected_plans += 1
            raise ValueError("plan.tenants must be a list")
        queued = 0
        for row in tenants:
            tname = row.get("tenant")
            for act in row.get("actions") or []:
                kind = act.get("kind")
                if kind not in ACTION_KINDS:
                    self.rejected_plans += 1
                    raise ValueError(
                        f"tenant {tname!r}: unknown action kind {kind!r} "
                        f"(want one of {tuple(ACTION_KINDS)})")
                for field in ACTION_KINDS[kind]:
                    if field not in act:
                        self.rejected_plans += 1
                        raise ValueError(
                            f"tenant {tname!r}: {kind} action missing "
                            f"required field {field!r}")
                self._queue.append({"tenant": tname, **act})
                queued += 1
        self.plans_ingested += 1
        self.actions_queued += queued
        return queued

    # -- the executor seam ---------------------------------------------------
    def apply_next(self) -> Optional[dict]:
        """Pop and record the next queued action (``applied: False``: the
        timeline says exactly what an executor would have run)."""
        if not self._queue:
            return None
        act = self._queue.popleft()
        entry = dict(act, applied=False)
        self.timeline.append(entry)
        return entry

    # -- introspection -------------------------------------------------------
    def pending(self) -> List[dict]:
        return list(self._queue)

    def section(self) -> dict:
        """JSON-able snapshot."""
        return {
            "schema": PLAN_SCHEMA,
            "plans_ingested": self.plans_ingested,
            "rejected_plans": self.rejected_plans,
            "actions_queued": self.actions_queued,
            "pending": list(self._queue),
            "timeline": list(self.timeline),
        }


_default: Optional[TenantScheduler] = None


def default_scheduler() -> TenantScheduler:
    """Process singleton, as ``tenant_ledger.default_ledger()``."""
    global _default
    if _default is None:
        _default = TenantScheduler()
    return _default
