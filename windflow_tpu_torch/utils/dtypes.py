"""Dtype policy for writes into carried device state (the port's copy of
``windflow_tpu/utils/dtypes.py``): the state dtype is authoritative; a
same-kind cast or a promotion that lands on the state dtype is allowed,
anything else would corrupt state and raises."""

from __future__ import annotations

import torch

from windflow_tpu_torch.basic import WindFlowError


def _kind(dt: torch.dtype) -> str:
    if dt == torch.bool:
        return "b"
    if dt.is_complex:
        return "c"
    if dt.is_floating_point:
        return "f"
    return "i" if dt.is_signed else "u"


def cast_state_update(u: torch.Tensor, dtype: torch.dtype,
                      what: str = "stateful update") -> torch.Tensor:
    """Cast update ``u`` to the state ``dtype`` under the policy above."""
    if u.dtype == dtype:
        return u
    if _kind(u.dtype) == _kind(dtype):
        return u.to(dtype)
    if torch.promote_types(u.dtype, dtype) == dtype:
        return u.to(dtype)
    raise WindFlowError(
        f"{what} dtype {u.dtype} does not match the state dtype {dtype} "
        "(the cast would corrupt state); make the function return the "
        "state's kind or widen the state prototype")


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    import numpy as np
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype))).dtype


def numpy_dtype(dt: torch.dtype):
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dt).numpy().dtype
