"""Multi-process execution: meshes whose host boundaries fall along the
key axis, and process-local staging (the port of
``windflow_tpu/parallel/multihost.py``).

* **Key axis across processes, data axis within one.**  Keyed state is
  sharded over ``key``, laid out so process boundaries fall along it;
  the per-step gather of staged tuples over ``data`` stays inside a
  process, and only the key-axis collectives (the tables' psum, the
  ``"flat"`` ingest's key hop, the arbitrary-key all_to_all) cross.
* Every process runs the same graph; each stages only its local
  lanes (:func:`stage_local`), and the mesh collectives
  (``parallel/mesh.py``) exchange what crosses through the
  ``torch.distributed`` process group.

:func:`initialize` joins the process group (``torch.distributed``'s
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` by default; gloo
for CPU meshes, NCCL for CUDA ones) and is a no-op in one process, which
is also how the tests hold this module in-process, by emulating host
groups on a CPU mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.parallel.mesh import Mesh, place

_initialized = False


def process_count() -> int:
    """The process group's world size, 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the multi-process job (no-op in one process or when joined).
    ``coordinator_address`` is ``host:port``; the arguments default to
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    ``backend`` defaults to NCCL when CUDA is available, else gloo."""
    global _initialized
    import torch.distributed as dist
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if coordinator_address is None and num_processes in (None, 1):
        _initialized = True     # one process: nothing to join
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}"
                               f":{os.environ['MASTER_PORT']}")
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _initialized = True


def make_multihost_mesh(local_data: int = 1,
                        devices: Optional[Sequence] = None,
                        emulate_hosts: Optional[int] = None) -> Mesh:
    """The ``(data, key)`` mesh with host boundaries along ``key``.

    ``local_data`` is the data extent within each host (its devices split
    ``local_data x local_key``); the key axis concatenates every host's
    key block.  ``devices`` are this process's devices (default: the
    visible CUDA devices).  ``emulate_hosts`` splits one process's
    devices into that many host groups (the in-process test
    configuration); in a real multi-process job leave it None and the
    process group's topology is used, every process contributing as
    many devices as this one.  While a process group is up (also at world
    size 1) the mesh's collectives exchange through it."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    nproc, me = process_count(), process_index()
    if emulate_hosts or nproc == 1:
        groups = _split_groups(devs, emulate_hosts or 1)
        owners_of = [0] * len(groups)
        me = 0
    else:
        groups = [devs] * nproc
        owners_of = list(range(nproc))
    local = len(groups[0])
    if any(len(g) != local for g in groups):
        raise WindFlowError("hosts expose unequal device counts")
    if local % local_data:
        raise WindFlowError(f"{local} devices per host not divisible by "
                            f"local_data={local_data}")
    local_key = local // local_data
    arr = np.empty((local_data, len(groups) * local_key), dtype=object)
    owners = np.zeros(arr.shape, np.int64)
    for p, g in enumerate(groups):
        block = np.empty(local, dtype=object)
        block[:] = g
        arr[:, p * local_key:(p + 1) * local_key] = \
            block.reshape(local_data, local_key)
        owners[:, p * local_key:(p + 1) * local_key] = owners_of[p]
    import torch.distributed as dist
    group = dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() and not emulate_hosts else None
    return Mesh(arr, owners=owners, process_index=me, group=group)


def _split_groups(devs, n_groups: int):
    if len(devs) % n_groups:
        raise WindFlowError(
            f"{len(devs)} devices not divisible into {n_groups} host groups")
    per = len(devs) // n_groups
    return [devs[i * per:(i + 1) * per] for i in range(n_groups)]


def stage_local(hb, capacity: int, mesh: Mesh, spec: str = "flat"):
    """Stage a host batch on a (possibly multi-process) mesh.  One
    process: the batch padded to ``capacity`` and placed in ``spec``.
    Several: ``capacity`` is the global lane count, ``hb`` holds the
    lanes this process ingested (at most ``capacity / process_count``),
    and they land on its own positions (``"flat"``, the only layout a
    process can assemble from what it ingested).  Returns a
    ``DeviceBatch`` whose lanes are
    :class:`~windflow_tpu_torch.parallel.mesh.Sharded` values."""
    from windflow_tpu_torch.batch import DeviceBatch, host_to_device
    nproc = mesh.process_count
    if nproc > 1 and spec != "flat":
        raise WindFlowError("a multi-process mesh stages flat lanes only")
    db = host_to_device(hb, capacity=capacity // nproc, device=mesh.home)
    return DeviceBatch(place(db.payload, mesh, spec),
                       place(db.ts, mesh, spec), place(db.valid, mesh, spec),
                       watermark=db.watermark, size=None)
