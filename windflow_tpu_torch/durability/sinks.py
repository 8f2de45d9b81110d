"""Exactly-once file sinks: stage per epoch, atomic rename on commit (the
port of ``windflow_tpu/durability/sinks.py``; the committed files are the
same, so either package reads the other's).

:class:`EpochFileSink` is a plain Sink callable (pass it to
``Sink_Builder``) that makes a file-backed sink restart-safe:

* every record appends to a **staging** file under
  ``<dir>/.staging/`` — a crash mid-epoch leaves only staging garbage;
* at epoch commit (the durability plane calls :meth:`commit_epoch` at
  the checkpoint barrier, after the graph quiesced) the staging file is
  fsynced and ``os.replace``'d to ``<dir>/epoch_<e>.jsonl`` — atomic on
  POSIX, and idempotent: a replayed commit of the same epoch simply
  overwrites the file with the replay's (boundary-adjusted) content, so
  the concatenation of committed epochs is always the exact record
  sequence, no loss, no duplicates;
* at restore (:meth:`on_restore`) staging leftovers are discarded —
  committed epochs are the only truth.

Records are serialized one JSON object per line by default
(``serialize``/``deserialize`` override for other formats).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional


class EpochFileSink:
    """See module docstring.  Single logical writer per directory: give
    each sink replica its own directory (the replica index rides the
    runtime context) when running the sink replicated."""

    def __init__(self, dir: str,
                 serialize: Optional[Callable[[Any], str]] = None) -> None:
        self.dir = dir
        self._staging_dir = os.path.join(dir, ".staging")
        os.makedirs(self._staging_dir, exist_ok=True)
        self._ser = serialize or (lambda item: json.dumps(
            item, sort_keys=True, default=str))
        self._epoch = 0          # epoch currently staging
        self._f = None
        self.records_staged = 0
        self.epochs_committed = 0
        # a COLD restart after a crash (no restore — e.g. nothing was
        # checkpointed yet) constructs a fresh sink over the same dir:
        # the dead run's staged-but-uncommitted records must not leak
        # into this run's first epoch (staging appends).  on_restore()
        # covers the PipeGraph.restore() path; this covers cold starts.
        try:
            os.unlink(self._staging_path())
        except FileNotFoundError:
            pass

    # -- Sink callable contract ---------------------------------------------
    def __call__(self, item, ctx=None) -> None:
        if item is None:         # EOS: commit whatever is staged
            self.commit_epoch(self._epoch)
            return
        if self._f is None:
            self._f = open(self._staging_path(), "ab")
        self._f.write(self._ser(item).encode() + b"\n")
        self.records_staged += 1

    def _staging_path(self) -> str:
        return os.path.join(self._staging_dir, "open.jsonl")

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch:06d}.jsonl")

    # -- durability-plane hooks ----------------------------------------------
    def commit_epoch(self, epoch: int) -> None:
        """Atomically publish the staged records as epoch ``epoch``."""
        if self._f is None:
            self._epoch = epoch + 1
            return               # empty epoch: publish nothing
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        os.replace(self._staging_path(), self._epoch_path(epoch))
        self._epoch = epoch + 1
        self.epochs_committed += 1

    def on_restore(self, epoch: int) -> None:
        """Discard staging leftovers from the crashed run; replay
        re-stages everything past checkpoint ``epoch``."""
        if self._f is not None:
            self._f.close()
            self._f = None
        try:
            os.unlink(self._staging_path())
        except FileNotFoundError:
            pass
        self._epoch = epoch + 1

    # -- read-back (chaos diff / consumers) ----------------------------------
    @staticmethod
    def read_committed(dir: str,
                       deserialize: Optional[Callable[[str], Any]] = None
                       ) -> List[Any]:
        """All committed records in epoch order — staging files are
        never read (they are the not-yet-happened half of the story)."""
        de = deserialize or json.loads
        out: List[Any] = []
        try:
            names = sorted(n for n in os.listdir(dir)
                           if n.startswith("epoch_")
                           and n.endswith(".jsonl"))
        except FileNotFoundError:
            return out
        for name in names:
            with open(os.path.join(dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(de(line))
        return out
