"""Carrying window state across from the JAX package.

``ffat_state_from_numpy`` turns a count-window FFAT state of the JAX
package — the dict ``windflow_tpu.windows.ffat_kernels.make_ffat_state``
lays out (``carry``, ``carry_valid``, ``cur``, ``cur_valid``,
``cur_fill``, ``pane_base``, ``win_next``), its leaves as numpy arrays —
into the port's state, keeping every dtype.  A stream can then run its
first batches through one package and the rest through the other.
"""

from __future__ import annotations

import numpy as np
import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.utils.tree import tree_map

_KEYS = ("carry", "carry_valid", "cur", "cur_valid", "cur_fill",
         "pane_base", "win_next")


def ffat_state_from_numpy(state: dict, device="cpu") -> dict:
    """The port's FFAT CB state from a JAX state given as numpy arrays."""
    missing = [k for k in _KEYS if k not in state]
    if missing:
        raise WindFlowError(f"not an FFAT CB state: missing {missing}")

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return {k: tree_map(conv, state[k]) for k in _KEYS}
