"""Window specification (the port of ``WindowSpec`` from
``windflow_tpu/windows/engine.py``).  Window ``w`` covers domain values
``[w*slide, w*slide + win_len)``; the host window engine itself is not
ported yet."""

from __future__ import annotations

import dataclasses

from windflow_tpu_torch.basic import WinType


@dataclasses.dataclass
class WindowSpec:
    win_type: WinType          # CB (count) or TB (time, microseconds)
    win_len: int
    slide: int
    lateness: int = 0          # TB + DEFAULT mode only (usec)
