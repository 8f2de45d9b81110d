"""Serving plane (the port of ``windflow_tpu/serving``): the reshard
executor, which applies ``move_keys``/``split_hot_key`` plans to a live
graph (quiesce, re-place the key→shard map with the keyed state moving
along, resume, with no restart) and degrades admission at the sources
when no plan helps, and the tenant scheduler, which consumes the tenancy
advisor's plans."""

from windflow_tpu_torch.serving.executor import ReshardExecutor
from windflow_tpu_torch.serving.tenant_scheduler import TenantScheduler

__all__ = ["ReshardExecutor", "TenantScheduler"]
