"""Carrying operator state across from the JAX package.

* ``ffat_state_from_numpy`` turns a count-window FFAT state of the JAX
  package — the dict ``windflow_tpu.windows.ffat_kernels.make_ffat_state``
  lays out (``carry``, ``carry_valid``, ``cur``, ``cur_valid``,
  ``cur_fill``, ``pane_base``, ``win_next``), its leaves as numpy
  arrays — into the port's state;
* ``ffat_tb_state_from_numpy`` does the same for a time-window pane
  ring (``make_ffat_tb_state``: the ``cells`` pytree, ``cell_valid``,
  the int64 scalars ``base``, ``win_next`` and ``max_seen``, ``horizon``
  [K] and the counters ``n_late``, ``n_evicted``, ``n_win_dropped``);
* ``cstats_from_numpy`` does the same for the compacted reduce's stats
  (``windflow_tpu.parallel.compaction.cstats_init``: ``hits``,
  ``misses``, ``batches``, ``big``, ``cand``);
* ``stateful_state_from_numpy`` installs a stateful operator's state on
  the port's ``StatefulMapGPU`` / ``StatefulFilterGPU``: the blob
  ``snapshot_state()`` of the JAX package's operator returns (``state``,
  the ``[num_key_slots, ...]`` table as numpy; ``interner``, its key ->
  slot dict; ``compactor``, its remap snapshot or None).

All keep every dtype, so a stream can run its first batches through one
package and the rest through the other.
"""

from __future__ import annotations

import numpy as np
import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.utils.tree import tree_leaves, tree_map

_KEYS = ("carry", "carry_valid", "cur", "cur_valid", "cur_fill",
         "pane_base", "win_next")
_TB_KEYS = ("cells", "cell_valid", "base", "win_next", "max_seen",
            "horizon", "n_late", "n_evicted", "n_win_dropped")
_CSTATS_KEYS = ("hits", "misses", "batches", "big", "cand")


def _conv(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def ffat_state_from_numpy(state: dict, device="cpu") -> dict:
    """The port's FFAT CB state from a JAX state given as numpy arrays."""
    missing = [k for k in _KEYS if k not in state]
    if missing:
        raise WindFlowError(f"not an FFAT CB state: missing {missing}")
    return {k: tree_map(lambda a: _conv(a, device), state[k])
            for k in _KEYS}


def ffat_tb_state_from_numpy(state: dict, device="cpu") -> dict:
    """The port's FFAT TB pane ring from a JAX TB state given as numpy
    arrays."""
    missing = [k for k in _TB_KEYS if k not in state]
    if missing:
        raise WindFlowError(f"not an FFAT TB state: missing {missing}")
    return {k: tree_map(lambda a: _conv(a, device), state[k])
            for k in _TB_KEYS}


def cstats_from_numpy(cstats: dict, device="cpu") -> dict:
    """The port's compaction stats from a JAX ``cstats`` given as numpy
    arrays."""
    missing = [k for k in _CSTATS_KEYS if k not in cstats]
    if missing:
        raise WindFlowError(f"not a compaction stats state: missing "
                            f"{missing}")
    return {k: _conv(cstats[k], device) for k in _CSTATS_KEYS}


def stateful_state_from_numpy(op, blob: dict, device="cpu") -> None:
    """Install a JAX stateful operator's ``snapshot_state()`` on the
    port's stateful operator ``op``: the state table and the key -> slot
    map.  A remap snapshot's map is folded into the interner (the rows
    keep meaning the same keys), and a compactor the port's graph already
    attached is switched off, since a fresh remap would assign other
    slots; the operator then takes the interning route.  Installed
    before the graph runs, the build attaches no compactor to it."""
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    if not isinstance(op, _StatefulGPUBase):
        raise WindFlowError(f"'{getattr(op, 'name', op)}' is not a "
                            "stateful GPU operator")
    missing = [k for k in ("state", "interner") if k not in blob]
    if missing:
        raise WindFlowError(f"not a stateful state: missing {missing}")
    state = tree_map(lambda a: _conv(a, device), blob["state"])
    if tree_map(lambda a: tuple(a.shape[1:]), state) != tree_map(
            lambda a: tuple(a.shape[1:]), op._state) \
            or next(iter(tree_leaves(state))).shape[0] != op.num_key_slots:
        raise WindFlowError(
            f"operator '{op.name}': the state table's layout differs from "
            "the operator's (slots or per-key shapes)")
    ids = {int(k): int(v) for k, v in blob["interner"].items()}
    cblob = blob.get("compactor")
    if cblob is not None:
        ids.update({int(k): int(v) for k, v in cblob["key_slot"].items()})
    op._state = state
    op._interner._ids = ids
    if op._compactor is not None and ids:
        op._compactor.deactivate()
        op._compactor = None
