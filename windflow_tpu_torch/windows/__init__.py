"""Windows of the port: the host window operators (``ops.py``,
``ffat_op.py`` over ``flatfat.py``, all on ``engine.py``) and the device
FFAT windows (``ffat_gpu.py``)."""
from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
from windflow_tpu_torch.windows.ffat_op import FfatWindows
from windflow_tpu_torch.windows.flatfat import FlatFAT
from windflow_tpu_torch.windows.ops import (KeyedWindows, MapReduceWindows,
                                            PanedWindows, ParallelWindows,
                                            WindowResult)
