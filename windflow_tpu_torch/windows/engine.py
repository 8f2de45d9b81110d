"""Window specification (the port of ``WindowSpec`` from
``windflow_tpu/windows/engine.py``).  Window ``w`` covers domain values
``[w*slide, w*slide + win_len)``: tuple ranks for count-based windows,
event times in µs for time-based ones (both run on the card, in
``windows/ffat_gpu.py``).  The host window engine is not ported yet."""

from __future__ import annotations

import dataclasses

from windflow_tpu_torch.basic import WinType


@dataclasses.dataclass
class WindowSpec:
    win_type: WinType          # CB (count) or TB (time, microseconds)
    win_len: int
    slide: int
    lateness: int = 0          # TB + DEFAULT mode only (usec)
