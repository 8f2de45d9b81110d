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
  ``misses``, ``batches``, ``big``, ``cand``).

All keep every dtype.  A whole operator's state crosses as its
``snapshot_state()`` blob, which either package's ``restore_state``
takes (``windflow_tpu_torch/durability``).
"""

from __future__ import annotations

import numpy as np
import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.utils.tree import tree_map

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
