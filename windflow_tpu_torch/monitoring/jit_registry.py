"""The step registry: the port of ``windflow_tpu/monitoring/
jit_registry.py``'s table over the port's steps.

The JAX package wraps every ``jax.jit`` site in ``wf_jit`` and counts
compiles, recompiles and dispatches per op name.  The port has no jit:
its steps are eager torch calls, and on the card a megastep edge
captures K of them as one CUDA graph (``megastep.py``).  So the registry
keeps the JAX package's per-op table and totals schema
(``OpCompileEntry.to_json``, ``totals``, ``dispatch_counts``) with these
meanings:

* **dispatches** — one step call, or one row of a megastep replay (a
  replay of K batches counts K);
* **compiles** — captures of a ``kernels.ffat_cuda.CountedGraph``;
* **recompiles** — recaptures of the same edge (a TB ring regrow, for
  one);
* **cost columns** (``cost``, ``memory``, ``donation``) — ``None``: there
  is no XLA cost analysis, and in-place torch steps donate nothing.
  ``provenance`` says so.

Each operator holds a :class:`StepWatch` (``Operator.watch``, made at
its first step); the sweep ledger (``monitoring/sweep_ledger.py``)
attributes a hop's dispatches from its watches, and reads the tensor
bytes the watch took from the first step's input, output and state
tensors (metadata only: no device read).  Counting a dispatch is two
integer adds.  The health plane's capture-storm check reads the
recompiles.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from windflow_tpu_torch.analysis.hotpath import hot_path

#: what the table's columns mean in the port (``OpCompileEntry.to_json``)
PROVENANCE = ("torch steps: dispatches are step calls (a megastep replay "
              "counts its K rows), compiles are CUDA graph captures, "
              "recompiles are recaptures of one edge; no XLA cost analysis "
              "and no buffer donation, so cost, memory and donation are "
              "None")


def _nbytes(tree) -> int:
    """Bytes of the tensors in a pytree (shapes only, no device read)."""
    from windflow_tpu_torch.utils.tree import tree_leaves
    total = 0
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "element_size") and hasattr(leaf, "numel"):
            total += leaf.numel() * leaf.element_size()
    return total


def batch_nbytes(batch) -> int:
    """Bytes of a DeviceBatch's lanes: payload, ts, valid and keys."""
    if batch is None:
        return 0
    return _nbytes([batch.payload, batch.ts, batch.valid, batch.keys])


class OpCompileEntry:
    """Aggregate telemetry of one op name (process-wide: every watch of
    that name feeds it)."""

    __slots__ = ("op_name", "compiles", "recompiles", "compile_ms_total",
                 "last_compile_ms", "dispatches", "lock")

    def __init__(self, op_name: str) -> None:
        self.op_name = op_name
        self.compiles = 0
        self.recompiles = 0
        self.compile_ms_total = 0.0
        self.last_compile_ms = 0.0
        #: bumped lock-free per dispatch, read at stats cadence
        self.dispatches = 0
        self.lock = threading.Lock()

    def to_json(self) -> dict:
        return {
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "compile_ms_total": round(self.compile_ms_total, 3),
            "last_compile_ms": round(self.last_compile_ms, 3),
            "dispatches": self.dispatches,
            "cost": None,
            "memory": None,
            "donation": None,
            "provenance": PROVENANCE,
        }


class StepWatch:
    """One operator's (or one emitter program's) handle: the dispatches
    and captures it made, and the tensor bytes of one step."""

    __slots__ = ("op_name", "dispatches", "captures", "tensor_bytes",
                 "out_bytes", "_entry")

    def __init__(self, entry: OpCompileEntry) -> None:
        self.op_name = entry.op_name
        self._entry = entry
        #: this handle's own count (per-hop attribution: two graphs
        #: reusing an op name never credit each other)
        self.dispatches = 0
        self.captures = 0
        #: bytes one step reads and writes (input batch, output batch,
        #: operator state), taken at the first step; None before
        self.tensor_bytes: Optional[int] = None
        #: bytes of the first step's output batch
        self.out_bytes: Optional[int] = None

    @hot_path
    def note(self, n: int = 1) -> None:
        """``n`` dispatches (a megastep replay notes its K rows)."""
        self.dispatches += n
        self._entry.dispatches += n

    @hot_path
    def note_step(self, batch, out, op=None) -> None:
        """One step call of ``op``; the first one also takes the tensor
        bytes (the batch in and out, and the state the operator holds,
        read and written)."""
        self.dispatches += 1
        self._entry.dispatches += 1
        if self.tensor_bytes is None:
            state = (getattr(op, "_states", None), getattr(op, "_state", None))
            self.out_bytes = batch_nbytes(out)
            self.tensor_bytes = batch_nbytes(batch) + self.out_bytes \
                + 2 * _nbytes(state)

    def note_capture(self, ms: float) -> None:
        """One CUDA graph capture of this handle's step; every capture
        after the first is a recapture (the registry's recompile)."""
        e = self._entry
        with e.lock:
            e.compiles += 1
            e.compile_ms_total += ms
            e.last_compile_ms = ms
            if self.captures:
                e.recompiles += 1
        self.captures += 1


class JitRegistry:
    """Process-wide op name -> :class:`OpCompileEntry` table."""

    def __init__(self) -> None:
        self._entries: Dict[str, OpCompileEntry] = {}
        self._lock = threading.Lock()

    def entry(self, op_name: str) -> OpCompileEntry:
        with self._lock:
            e = self._entries.get(op_name)
            if e is None:
                e = self._entries[op_name] = OpCompileEntry(op_name)
            return e

    def watch(self, op_name: str) -> StepWatch:
        return StepWatch(self.entry(op_name))

    def snapshot(self) -> dict:
        """JSON-ready per-op table (``stats()["Device"]["jit"]``): every
        op name that dispatched or captured."""
        with self._lock:
            entries = dict(self._entries)
        return {name: e.to_json() for name, e in sorted(entries.items())
                if e.compiles or e.recompiles or e.dispatches}

    def totals(self) -> dict:
        with self._lock:
            entries = tuple(self._entries.values())
        return {
            "ops_compiled": sum(1 for e in entries if e.compiles),
            "compiles": sum(e.compiles for e in entries),
            "recompiles": sum(e.recompiles for e in entries),
            "compile_ms_total": round(sum(e.compile_ms_total
                                          for e in entries), 3),
        }

    def dispatch_counts(self) -> Dict[str, int]:
        """op name -> cumulative dispatches (the sweep ledger baselines
        this at graph build)."""
        with self._lock:
            entries = dict(self._entries)
        return {name: e.dispatches for name, e in entries.items()}

    def reset(self) -> None:
        """Drop every entry (tests); live watches keep feeding theirs."""
        with self._lock:
            self._entries.clear()


_default_registry = JitRegistry()


def default_registry() -> JitRegistry:
    """The process-wide registry every watch reports into."""
    return _default_registry
