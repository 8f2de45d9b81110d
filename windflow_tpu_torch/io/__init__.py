"""Bulk ingest: columnar sources (the port of ``windflow_tpu/io``)."""

from windflow_tpu_torch.io.device_source import DeviceSource
from windflow_tpu_torch.io.frames import FrameSource

__all__ = ["DeviceSource", "FrameSource"]
