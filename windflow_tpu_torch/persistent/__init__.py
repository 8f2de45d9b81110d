"""Embedded durable key/value store (the port of
``windflow_tpu/persistent/kv.py``): the log the durability plane's
checkpoints live in.  The persistent operator suite comes with the
host-side remainder."""

from windflow_tpu_torch.persistent.kv import LogKV, close_shared, open_shared

__all__ = ["LogKV", "open_shared", "close_shared"]
