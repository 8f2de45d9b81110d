"""Multi-GPU execution: a ``(data, key)`` mesh of torch devices,
key-sharded window/reduce/stateful state, and the collectives between
the shards (the port of ``windflow_tpu/parallel/mesh.py``).

* **The mesh.** :class:`Mesh` is a ``(data, key)`` grid of
  ``torch.device`` positions with the JAX mesh's surface (``shape``,
  ``axis_names``, ``devices``).  A device may repeat: 8 x ``cpu`` on the
  CPU and 4 x ``cuda:0`` on one card are logical meshes, the port's
  counterpart of XLA's virtual host devices.  Positions on distinct
  cards (``cuda:0..n-1``) take the same code: every hand-off between
  positions is a ``.to(position_device)``, a no-op when they share one.
* **Placement.** A sharded value (:class:`Sharded`) holds one tensor (or
  one pytree) per mesh position of this process, on that position's
  device, under one of four layouts: ``"data"`` (lanes split along
  ``data``, replicated along ``key``: JAX's ``batch_sharding``),
  ``"flat"`` (split over ``(data, key)`` in data-major order),
  ``"key"`` (split along ``key``, replicated along ``data``:
  ``state_sharding``) and ``"rep"`` (replicated).  Key-sharded state is
  replicated along ``data`` as ``P(KEY_AXIS)`` is in JAX: every data row
  runs the same step on the gathered batch and holds equal state.
* **Collectives.** :func:`all_gather` (tiled or stacked), :func:`psum`,
  :func:`pmax`, :func:`pmin` and :func:`all_to_all` over a mesh axis, and
  :func:`axis_index`.  Within a process they are torch copies and
  reductions; a collective whose groups span processes
  (``parallel/multihost.py``) first exchanges every position's operand
  through ``torch.distributed``.  Each collective records itself (kind,
  axes, elements an operand) into the open :func:`recording` lists, which
  the capture audit reads for WF901.
* **Sharded steps.** JAX's ``shard_map`` bodies call collectives
  mid-body; here each factory runs in phases split at its collectives: a
  local pass per position, the collective, a local pass per position.
  Each per-shard local step is the single-device step factory
  (``windows/ffat_kernels.make_ffat_step`` and its TB and flush twins,
  the stateful bodies) called with its shard's ``key_base``, so the
  grouping and fold kernels launch per key shard and position wherever
  the single-device step launches them.  Step outputs come back as
  tensors assembled on the mesh's home position (the first position of
  this process); state stays a :class:`Sharded` value.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.utils.tree import (per_record, tree_flatten,
                                           tree_map, tree_unflatten)

DATA_AXIS = "data"
KEY_AXIS = "key"
AXES = (DATA_AXIS, KEY_AXIS)

Pos = Tuple[int, int]


class Mesh:
    """A ``(data, key)`` grid of torch devices.  ``owners[d, k]`` is the
    process that holds position ``(d, k)`` (all 0 in one process); a
    multi-process mesh (``multihost.make_multihost_mesh``) places host
    boundaries along ``key``.  ``group`` is the ``torch.distributed``
    process group its collectives exchange through (None: one process,
    no group; a multi-process mesh, or one built while a group is up,
    carries it, and then every collective goes through it)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, owners: Optional[np.ndarray] = None,
                 process_index: int = 0, group=None) -> None:
        self.devices = devices
        self.group = group
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64))
        self.process_index = int(process_index)
        dd, kk = devices.shape
        self.local_positions: List[Pos] = [
            (d, k) for d in range(dd) for k in range(kk)
            if self.owners[d, k] == self.process_index]
        self.local_columns = sorted({k for _, k in self.local_positions})
        if not self.local_positions:
            raise WindFlowError("the mesh holds no position of this process")

    @property
    def shape(self) -> Dict[str, int]:
        dd, kk = self.devices.shape
        return {DATA_AXIS: dd, KEY_AXIS: kk}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_count(self) -> int:
        return int(self.owners.max()) + 1

    @property
    def home(self) -> torch.device:
        """Where assembled step outputs land: this process's first
        position."""
        return self.device_of(self.local_positions[0])

    def device_of(self, pos: Pos) -> torch.device:
        return self.devices[pos]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{sorted({str(d) for d in self.devices.ravel()})}, "
                f"processes={self.process_count})")


def make_mesh(n_devices: Optional[int] = None, data: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a ``(data, key)`` mesh over the first ``n_devices`` devices.

    ``devices`` defaults to the visible CUDA devices and may repeat one
    device (a logical mesh); the mesh never drops to the CPU on its own.
    ``data`` fixes the data-parallel extent; the key axis takes the
    rest.  With ``data=1`` the mesh is pure key sharding."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise WindFlowError(
                f"requested {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise WindFlowError("no device visible for the mesh; pass devices=")
    if n % data != 0:
        raise WindFlowError(f"{n} devices not divisible by data={data}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, n // data))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

SPECS = ("data", "flat", "key", "rep")


class Sharded:
    """One tensor (or pytree) per mesh position of this process, on that
    position's device, under layout ``spec`` (module docstring)."""

    __slots__ = ("mesh", "spec", "blocks")

    def __init__(self, mesh: Mesh, spec: str, blocks: Dict[Pos, object]):
        self.mesh = mesh
        self.spec = spec
        self.blocks = blocks

    def full(self):
        """The assembled value on the home position (:func:`assemble`)."""
        return assemble(self)

    def equal_across_data(self) -> bool:
        """Whether every data row holds the same blocks, as key-sharded
        state replicated along ``data`` must."""
        for (d, k), blk in self.blocks.items():
            ref = self.blocks.get((0, k))
            if ref is None:
                continue
            for a, b in zip(tree_flatten(blk)[0], tree_flatten(ref)[0]):
                if not torch.equal(a.cpu(), b.cpu()):
                    return False
        return True


def _chunk(a: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if a.shape[0] % n:
        raise WindFlowError(
            f"a lane of {a.shape[0]} not divisible by {n} mesh blocks")
    m = a.shape[0] // n
    return a[i * m:(i + 1) * m]


def _place_leaf(a, mesh: Mesh, spec: str, pos: Pos, j: int):
    a = torch.as_tensor(a)
    dd, kk = mesh.devices.shape
    d, k = pos
    if spec == "rep":
        blk = a
    elif spec == "key":
        blk = _chunk(a, kk, k)
    elif spec == "data":
        blk = _chunk(a, dd, d)
    else:
        # "flat": the lanes of this process's positions, in their order
        blk = _chunk(a, len(mesh.local_positions), j)
    return blk.to(mesh.device_of(pos))


def place(tree, mesh: Mesh, spec: str) -> Sharded:
    """Lay a value out over ``mesh`` (the counterpart of a sharded
    ``device_put``): a tensor, or a pytree leaf by leaf.  Under
    ``"flat"`` the value holds this process's lanes (all of them in one
    process)."""
    if spec not in SPECS:
        raise WindFlowError(f"unknown mesh layout '{spec}'")
    if isinstance(tree, Sharded):
        return reshard(tree, spec)
    return Sharded(mesh, spec, {
        pos: tree_map(lambda a: _place_leaf(a, mesh, spec, pos, j), tree)
        for j, pos in enumerate(mesh.local_positions)})


def reshard(s: Sharded, spec: str) -> Sharded:
    """``s`` under another layout (through its assembled value)."""
    if s.spec == spec:
        return s
    if s.mesh.process_count > 1:
        raise WindFlowError(
            f"a '{s.spec}' value cannot be re-laid out as '{spec}' across "
            "processes; stage it in the layout the step consumes")
    return place(assemble(s), s.mesh, spec)


def _cat_leaves(leaves: List[torch.Tensor], home) -> torch.Tensor:
    leaves = [a.to(home) for a in leaves]
    if leaves[0].ndim == 0:
        return torch.stack(leaves)
    return torch.cat(leaves)


def assemble(s: Sharded):
    """The value of ``s`` as tensors on the home position: a key-sharded
    value concatenates this process's key columns (0-d per-shard lanes
    stack), a data-sharded one the data rows, a flat one this process's
    positions; a replicated value is the home block."""
    mesh = s.mesh
    home = mesh.home
    dd, _ = mesh.devices.shape
    if s.spec == "rep":
        return tree_map(lambda a: a.to(home),
                        s.blocks[mesh.local_positions[0]])
    if s.spec == "key":
        d0 = mesh.local_positions[0][0]
        parts = [s.blocks[(d0, k)] for k in mesh.local_columns]
    elif s.spec == "data":
        k0 = mesh.local_columns[0]
        parts = [s.blocks[(d, k0)] for d in range(dd)]
    else:
        parts = [s.blocks[p] for p in mesh.local_positions]
    flat = [tree_flatten(p)[0] for p in parts]
    treedef = tree_flatten(parts[0])[1]
    return tree_unflatten(treedef, [_cat_leaves([f[i] for f in flat], home)
                                    for i in range(len(flat[0]))])


def _blocks(x, mesh: Mesh, spec: str) -> Dict[Pos, object]:
    """Per-position blocks of a step operand: a :class:`Sharded` value
    (re-laid out if it is not in ``spec``) or a value placed here."""
    if isinstance(x, Sharded):
        return reshard(x, spec).blocks
    return place(x, mesh, spec).blocks


def _tree_blocks(tree, mesh: Mesh, spec: str) -> Dict[Pos, object]:
    """Per-position blocks of a pytree whose leaves may each be a
    :class:`Sharded` value."""
    if isinstance(tree, Sharded):
        return reshard(tree, spec).blocks
    leaves, treedef = tree_flatten(tree)
    per_leaf = [_blocks(a, mesh, spec) for a in leaves]
    return {pos: tree_unflatten(treedef, [b[pos] for b in per_leaf])
            for pos in mesh.local_positions}


def stage_batch(payload, ts, valid, mesh: Mesh, spec: str = "data"):
    """Host→mesh staging of one batch's lanes (padded to its capacity):
    ``(payload, ts, valid)`` as :class:`Sharded` values in ``spec``
    (``"data"`` by default, the single-host layout)."""
    return (Sharded(mesh, spec, _tree_blocks(payload, mesh, spec)),
            place(ts, mesh, spec), place(valid, mesh, spec))


def shard_state(tree, mesh: Mesh, scalars: Sequence[str] = ()) -> Sharded:
    """A global state pytree (leading axis = key rows) laid out
    key-sharded; the top-level fields named in ``scalars`` are
    ``[key shards]`` lanes whose shard holds one 0-d element."""
    out = {}
    for j, pos in enumerate(mesh.local_positions):
        k = pos[1]

        def shard(a, scalar=False):
            if scalar:
                return torch.as_tensor(np.asarray(a)[k]).to(
                    mesh.device_of(pos))
            return _place_leaf(a, mesh, "key", pos, j)
        if isinstance(tree, dict):
            out[pos] = {name: (shard(leaf, True) if name in scalars
                               else tree_map(shard, leaf))
                        for name, leaf in tree.items()}
        else:
            out[pos] = tree_map(shard, tree)
    return Sharded(mesh, "key", out)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_RECORDS = threading.local()


@contextmanager
def recording():
    """Collect every collective run inside the block as dicts ``{"op",
    "axes", "numel", "crosses_key"}`` (the capture audit's WF901 facts)."""
    stack = getattr(_RECORDS, "stack", None)
    if stack is None:
        stack = _RECORDS.stack = []
    rec: List[dict] = []
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def _record(kind: str, axes, mesh: Mesh, numel: int) -> None:
    stack = getattr(_RECORDS, "stack", None)
    if not stack:
        return
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    entry = {"op": kind, "axes": list(axes), "numel": int(numel),
             "crosses_key": KEY_AXIS in axes
             and mesh.shape[KEY_AXIS] > 1}
    for rec in stack:
        rec.append(entry)


def _group(mesh: Mesh, pos: Pos, axes) -> List[Pos]:
    """The positions a collective over ``axes`` combines for ``pos``, in
    axis order (data-major over both axes)."""
    dd, kk = mesh.devices.shape
    d, k = pos
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if axes == (DATA_AXIS,):
        return [(i, k) for i in range(dd)]
    if axes == (KEY_AXIS,):
        return [(d, j) for j in range(kk)]
    if set(axes) == set(AXES):
        return [(i, j) for i in range(dd) for j in range(kk)]
    raise WindFlowError(f"unknown mesh axes {axes}")


def _exchange(grid: Dict[Pos, torch.Tensor], mesh: Mesh, axes):
    """Every position's operand of one collective, this process's and
    (for groups that span processes) the others', received through the
    ``torch.distributed`` process group."""
    if mesh.group is None and (mesh.process_count == 1 or all(
            mesh.owners[q] == mesh.process_index
            for p in mesh.local_positions for q in _group(mesh, p, axes))):
        return grid
    import torch.distributed as dist
    local = mesh.local_positions
    ref = grid[local[0]]
    is_bool = ref.dtype == torch.bool
    wire_dev = ref.device if dist.get_backend(mesh.group) == "nccl" \
        else "cpu"

    def wire(t):
        t = t.to(torch.uint8) if is_bool else t
        return t.to(wire_dev)
    mine = torch.stack([wire(grid[p]) for p in local]).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.process_count)]
    dist.all_gather(parts, mine, group=mesh.group)
    full = dict(grid)
    dd, kk = mesh.devices.shape
    for r, part in enumerate(parts):
        if r == mesh.process_index:
            continue
        theirs = [(d, k) for d in range(dd) for k in range(kk)
                  if mesh.owners[d, k] == r]
        for i, q in enumerate(theirs):
            t = part[i].to(ref.device)
            full[q] = t.to(torch.bool) if is_bool else t
    return full


def all_gather(grid: Dict[Pos, torch.Tensor], mesh: Mesh, axes,
               tiled: bool = True) -> Dict[Pos, torch.Tensor]:
    """Each position receives its group's operands, concatenated along
    axis 0 (``tiled``) or stacked on a new one."""
    full = _exchange(grid, mesh, axes)
    _record("all_gather", axes, mesh, next(iter(grid.values())).numel())
    join = torch.cat if tiled else torch.stack
    out = {}
    for p in grid:
        dev = mesh.device_of(p)
        out[p] = join([full[q].to(dev) for q in _group(mesh, p, axes)])
    return out


def _reduce(grid, mesh: Mesh, axes, kind: str):
    full = _exchange(grid, mesh, axes)
    _record(kind, axes, mesh, next(iter(grid.values())).numel())
    out = {}
    for p in grid:
        dev = mesh.device_of(p)
        st = torch.stack([full[q].to(dev) for q in _group(mesh, p, axes)])
        if kind == "psum":
            out[p] = st.sum(0, dtype=st.dtype) if st.dtype != torch.bool \
                else st.any(0)
        elif kind == "pmax":
            out[p] = st.amax(0)
        else:
            out[p] = st.amin(0)
    return out


def psum(grid, mesh: Mesh, axes):
    return _reduce(grid, mesh, axes, "psum")


def pmax(grid, mesh: Mesh, axes):
    return _reduce(grid, mesh, axes, "pmax")


def pmin(grid, mesh: Mesh, axes):
    return _reduce(grid, mesh, axes, "pmin")


def all_to_all(grid: Dict[Pos, torch.Tensor], mesh: Mesh,
               axes) -> Dict[Pos, torch.Tensor]:
    """Operand ``[n, ...]`` (n = the group's size): row ``i`` of every
    position goes to the group's ``i``-th position, which stacks the rows
    it receives in group order."""
    full = _exchange(grid, mesh, axes)
    _record("all_to_all", axes, mesh, next(iter(grid.values())).numel())
    out = {}
    for p in grid:
        dev = mesh.device_of(p)
        grp = _group(mesh, p, axes)
        i = grp.index(p)
        out[p] = torch.stack([full[q][i].to(dev) for q in grp])
    return out


def axis_index(mesh: Mesh, pos: Pos, axis: str) -> int:
    return pos[0] if axis == DATA_AXIS else pos[1]


def _collective(kind: str) -> Callable:
    return {"sum": psum, "max": pmax, "min": pmin}[kind]


def _tree_collective(fn, grid_trees: Dict[Pos, object], mesh: Mesh, axes,
                     **kw):
    """Run a collective leaf by leaf over per-position pytrees."""
    pos0 = next(iter(grid_trees))
    leaves0, treedef = tree_flatten(grid_trees[pos0])
    flat = {p: tree_flatten(t)[0] for p, t in grid_trees.items()}
    outs = [fn({p: flat[p][i] for p in flat}, mesh, axes, **kw)
            for i in range(len(leaves0))]
    return {p: tree_unflatten(treedef, [o[p] for o in outs])
            for p in grid_trees}


# ---------------------------------------------------------------------------
# aligned ingest
# ---------------------------------------------------------------------------

def _aligned_slot_bound(op) -> Optional[int]:
    """The dense slot space an aligned emitter places by, or None when
    the operator cannot take aligned ingest: key-sharded
    ``FfatWindowsGPU`` with a declared dense key space, a
    ``withMaxKeys`` ``ReduceGPU`` and a ``withDenseKeys`` stateful
    Map/Filter.  Compacted key spaces stay unaligned."""
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    if op.key_extractor is None:
        return None
    if isinstance(op, FfatWindowsGPU):
        if op.max_keys is None or op._compactor is not None:
            return None
        return op.max_keys
    if isinstance(op, ReduceGPU):
        return op.max_keys
    if isinstance(op, _StatefulGPUBase):
        return op.num_key_slots if op.dense_keys else None
    return None


def mark_aligned_ingest(graph) -> None:
    """Stamp ``_ingest_mode="aligned"`` on each key-sharded consumer with
    a declared dense key/slot space (:func:`_aligned_slot_bound`) fed
    only by host staging edges under KEYBY routing at parallelism 1,
    with staging capacities divisible by the mesh's positions: the
    emitter dispatch then installs ``AlignedMeshStageEmitter`` on those
    edges and the consumer's step takes its aligned variant.
    Device-fed consumers, compacted key spaces and multi-process graphs
    keep the data-sharded ingest.  Called by ``PipeGraph._build`` after
    the replicas exist and before the edges are wired."""
    mesh = graph.config.mesh
    if mesh is None or mesh.process_count > 1:
        return
    kk, dd = mesh.shape[KEY_AXIS], mesh.shape[DATA_AXIS]
    ups = {}
    for edge in graph._edges():
        if edge[0] == "op":
            _, a, b = edge
            ups.setdefault(id(b), []).append(a)
        else:
            _, mp = edge
            src = mp.operators[-1]
            for child in mp.split_children:
                if child.operators:
                    ups.setdefault(id(child.operators[0]), []).append(src)
    for op in graph._topo_operators():
        if not getattr(op, "is_gpu", False):
            continue
        bound = _aligned_slot_bound(op)
        if bound is None or not op.is_keyed or op.parallelism != 1 \
                or bound % kk:
            continue
        feeds = ups.get(id(op), [])
        if not feeds or any(u.is_gpu for u in feeds):
            continue
        if any((u.output_batch_size or 0) % (kk * dd) for u in feeds):
            continue
        op._ingest_mode = "aligned"


# ---------------------------------------------------------------------------
# keyed reduce over the mesh
# ---------------------------------------------------------------------------

def _dense_keyed_partial(keys, vals, valid, comb, K: int, kernels: bool):
    """A position's dense partial table: keys grouped (the grouping kernel
    under its gate), a segmented scan, the segment tails scattered into
    rows of a ``[K, ...]`` table; ``(table, has)``."""
    from windflow_tpu_torch.windows.ffat_kernels import (_group_order,
                                                         _seg_scan)
    dev = keys.device
    sk = torch.where(valid & (keys >= 0) & (keys < K), keys,
                     torch.full_like(keys, K)).contiguous()
    order = _group_order(sk, K + 1, kernels).long()
    sk_s = sk[order]
    sv = tree_map(lambda a: a[order], vals)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    starts = torch.cat([true1, sk_s[1:] != sk_s[:-1]])
    scanned = _seg_scan(comb, starts, sv)
    ends = torch.cat([sk_s[:-1] != sk_s[1:], true1])
    row = torch.where(ends & (sk_s < K), sk_s, K).long()

    def scat(leaf):
        buf = torch.zeros((K + 1,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                          device=dev)
        buf[row] = leaf
        return buf[:K]
    table = tree_map(scat, scanned)
    has = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    # index_fill_, not ``has[row] = True``: a Python value put by index
    # goes through a host tensor (a synchronising copy on the card)
    has.index_fill_(0, row, True)
    return table, has[:K]


def _keys_of(key_fn, payload, n: int, dev) -> torch.Tensor:
    if key_fn is None:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    return per_record(key_fn, payload, n).to(torch.int32)


def _monoid_identity(kind: str, dtype):
    from windflow_tpu_torch.kernels.ffat_cuda import monoid_identity
    return monoid_identity(kind, dtype)


def _check_cap(capacity: int, n: int, what: str) -> None:
    if capacity % n:
        raise WindFlowError(f"capacity {capacity} not divisible by {n} "
                            f"{what}")


def make_sharded_reduce_step(mesh: Mesh, capacity: int, K: int,
                             comb: Callable, key_fn: Optional[Callable],
                             use_psum: bool = False,
                             monoid: Optional[str] = None,
                             ingest: str = "data", kernels: bool = False,
                             op_name: str = "mesh.reduce_step"):
    """Sharded ReduceGPU step ``fn(payload, ts, valid) -> (table, ts_out,
    has, n_dropped)``: ``table`` the dense ``[K]`` combined-record table,
    ``ts_out`` the per-key max input timestamp, ``has`` the occupancy
    mask, ``n_dropped`` the device count of valid tuples whose key fell
    outside ``[0, K)``.  Lanes arrive flat over ``(data, key)``; each
    position builds its dense partial table, and one collective combines
    them: ``psum``/``pmax``/``pmin`` for a declared ``monoid`` (legacy
    ``use_psum=True`` is ``"sum"``), else an all_gather and a fold.
    Non-keyed reduces pass ``key_fn=None`` with ``K == 1``.

    ``ingest="aligned"``: the host placed every tuple on its key owner's
    column (``key // K_local``), so each key shard builds only its own
    ``K_local`` rows from its column's lanes and the table combine
    disappears; only the within-column data-axis gather remains
    (nothing at ``data=1``) and the tables come back key-sharded."""
    from windflow_tpu_torch.windows.ffat_kernels import (_b,
                                                         _masked_reduce_last,
                                                         resolve_monoid)
    if use_psum and monoid is None:
        monoid = "sum"
    monoid = resolve_monoid(monoid)
    n = mesh.size
    _check_cap(capacity, n, "devices")
    kk, dd = mesh.shape[KEY_AXIS], mesh.shape[DATA_AXIS]
    if ingest not in ("data", "aligned"):
        raise WindFlowError(f"unknown reduce ingest layout '{ingest}'")
    blk = capacity // n

    def comb2(a, b):
        return (comb(a[0], b[0]), torch.maximum(a[1], b[1]))

    if ingest == "aligned":
        if K % kk:
            raise WindFlowError(
                f"max_keys {K} not divisible by key axis {kk}")
        K_local = K // kk

        def fn(payload, ts, valid):
            P = _tree_blocks(payload, mesh, "flat")
            T, V = _blocks(ts, mesh, "flat"), _blocks(valid, mesh, "flat")
            lks, oks, drops = {}, {}, {}
            for pos in mesh.local_positions:
                keys = _keys_of(key_fn, P[pos], blk, V[pos].device)
                base = axis_index(mesh, pos, KEY_AXIS) * K_local
                lk = keys - base
                in_range = (keys >= 0) & (keys < K) & (lk >= 0) \
                    & (lk < K_local)
                drops[pos] = (V[pos] & ~in_range).sum(dtype=torch.int64)
                lks[pos], oks[pos] = lk, V[pos] & in_range
            n_drop = psum(drops, mesh, AXES)
            if dd > 1:
                P = _tree_collective(all_gather, P, mesh, DATA_AXIS)
                lks = all_gather(lks, mesh, DATA_AXIS)
                T = all_gather(T, mesh, DATA_AXIS)
                oks = all_gather(oks, mesh, DATA_AXIS)
            tables, tss, hass = {}, {}, {}
            for pos in mesh.local_positions:
                (table, ts_t), has = _dense_keyed_partial(
                    lks[pos], (P[pos], T[pos]), oks[pos], comb2, K_local,
                    kernels)
                tables[pos] = table
                tss[pos] = torch.where(has, ts_t, torch.full_like(ts_t, -1))
                hass[pos] = has
            return (assemble(Sharded(mesh, "key", tables)),
                    assemble(Sharded(mesh, "key", tss)),
                    assemble(Sharded(mesh, "key", hass)),
                    assemble(Sharded(mesh, "rep", n_drop)))
        fn.op_name = op_name
        return fn

    def fn(payload, ts, valid):
        P = _tree_blocks(payload, mesh, "flat")
        T, V = _blocks(ts, mesh, "flat"), _blocks(valid, mesh, "flat")
        drops, tables, tss, hass = {}, {}, {}, {}
        for pos in mesh.local_positions:
            keys = _keys_of(key_fn, P[pos], blk, V[pos].device)
            drops[pos] = (V[pos] & ((keys < 0) | (keys >= K))).sum(
                dtype=torch.int64)
            (table, ts_t), has = _dense_keyed_partial(
                keys, (P[pos], T[pos]), V[pos], comb2, K, kernels)
            tables[pos], tss[pos], hass[pos] = table, ts_t, has
        n_drop = psum(drops, mesh, AXES)
        if monoid is not None:
            coll = _collective(monoid)
            z = {pos: tree_map(lambda a: torch.where(
                    _b(hass[pos], a), a,
                    torch.full((), _monoid_identity(monoid, a.dtype),
                               dtype=a.dtype, device=a.device)), t)
                 for pos, t in tables.items()}
            out = _tree_collective(coll, z, mesh, AXES)
            ts_out = pmax({pos: torch.where(hass[pos], tss[pos],
                                            torch.full_like(tss[pos], -1))
                           for pos in tss}, mesh, AXES)
            any_has = psum({pos: h.to(torch.int32)
                            for pos, h in hass.items()}, mesh, AXES)
            any_has = {pos: a > 0 for pos, a in any_has.items()}
        else:
            g_t = _tree_collective(all_gather, {
                pos: (tables[pos], tss[pos]) for pos in tables}, mesh, AXES,
                tiled=False)
            g_h = all_gather(hass, mesh, AXES, tiled=False)
            out, ts_out, any_has = {}, {}, {}
            for pos in g_t:
                anyf, (folded, ts_f) = _masked_reduce_last(
                    comb2, g_h[pos], g_t[pos], axis=0)
                out[pos], ts_out[pos], any_has[pos] = folded, ts_f, anyf
        return (assemble(Sharded(mesh, "rep", out)),
                assemble(Sharded(mesh, "rep", ts_out)),
                assemble(Sharded(mesh, "rep", any_has)),
                assemble(Sharded(mesh, "rep", n_drop)))
    fn.op_name = op_name
    return fn


def make_sharded_reduce_arbitrary(mesh: Mesh, capacity: int, comb: Callable,
                                  key_fn: Callable,
                                  op_name: str = "mesh.reduce_arbitrary"):
    """Keyed reduce over the mesh for an arbitrary int32 key space: each
    position buckets its lanes by owner (``key mod n`` on the uint32
    reinterpretation), one ``all_to_all`` routes every lane to its owner,
    and each position runs the sorted segmented reduce over the keys it
    owns.  ``fn(payload, ts, valid[, table_keys, table_slots]) ->
    (payload, ts, valid, n_dropped)``: each position's distinct-key rows
    are left-compacted into its ``[capacity]`` block of the concatenated
    output; ``n_dropped`` is always 0.  Given the compactor's
    ``table_keys, table_slots``, slotted keys route to owner
    ``slot % n`` instead of the hash."""
    from windflow_tpu_torch.ops.reduce import _segmented_reduce
    from windflow_tpu_torch.windows.grouping import auto_order
    n = mesh.size
    _check_cap(capacity, n, "devices")
    local_cap = capacity // n

    def fn(payload, ts, valid, *tables):
        P = _tree_blocks(payload, mesh, "flat")
        T, V = _blocks(ts, mesh, "flat"), _blocks(valid, mesh, "flat")
        bps, bts, bms = {}, {}, {}
        for pos in mesh.local_positions:
            dev = V[pos].device
            keys = _keys_of(key_fn, P[pos], local_cap, dev)
            own = ((keys.to(torch.int64) & 0xFFFFFFFF) % n).to(torch.int32)
            if tables:
                from windflow_tpu_torch.parallel.compaction import \
                    lookup_slots
                tk, tsl = (t.to(dev) for t in tables)
                slot, hit = lookup_slots(tk, tsl, keys, V[pos])
                own = torch.where(hit, slot % n, own)
            owner = torch.where(V[pos], own, torch.full_like(own, n))
            order = auto_order(owner.contiguous(), n + 1).long()
            so = owner[order]
            sp = tree_map(lambda a: a[order], P[pos])
            st, sv = T[pos][order], V[pos][order]
            p_ix = torch.arange(local_cap, device=dev)
            true1 = torch.ones(1, dtype=torch.bool, device=dev)
            starts = torch.cat([true1, so[1:] != so[:-1]])
            seg_start = torch.cummax(torch.where(starts, p_ix, 0), 0).values
            rank = p_ix - seg_start
            row = torch.where(sv & (so < n), so, n).long()

            def scat(leaf):
                buf = torch.zeros((n + 1, local_cap) + tuple(leaf.shape[1:]),
                                  dtype=leaf.dtype, device=dev)
                buf[row, rank] = leaf
                return buf[:n]
            bps[pos] = tree_map(scat, sp)
            bts[pos] = scat(st)
            bms[pos] = scat(sv & (so < n))
        rp = _tree_collective(all_to_all, bps, mesh, AXES)
        rt = all_to_all(bts, mesh, AXES)
        rm = all_to_all(bms, mesh, AXES)
        outs_p, outs_t, outs_v = {}, {}, {}
        for pos in mesh.local_positions:
            flat = lambda a: a.reshape((capacity,) + tuple(a.shape[2:]))  # noqa: E731
            fp = tree_map(flat, rp[pos])
            rkeys = _keys_of(key_fn, fp, capacity, rt[pos].device)
            _, op_, ot, ov = _segmented_reduce(
                rkeys, fp, flat(rt[pos]), flat(rm[pos]), comb, capacity)
            outs_p[pos], outs_t[pos], outs_v[pos] = op_, ot, ov
        zero = torch.zeros((), dtype=torch.int64, device=mesh.home)
        return (assemble(Sharded(mesh, "flat", outs_p)),
                assemble(Sharded(mesh, "flat", outs_t)),
                assemble(Sharded(mesh, "flat", outs_v)), zero)
    fn.op_name = op_name
    return fn


def make_sharded_keyed_reduce(mesh: Mesh, capacity: int, K: int,
                              comb: Callable, key_fn: Callable,
                              use_psum: bool = False,
                              monoid: Optional[str] = None,
                              kernels: bool = False,
                              op_name: str = "mesh.keyed_reduce"):
    """A keyed reduce over the whole mesh: :func:`make_sharded_reduce_step`
    without its timestamp and drop-count outputs, ``fn(payload, valid) ->
    (table, has)``, both replicated."""
    step = make_sharded_reduce_step(mesh, capacity, K, comb, key_fn,
                                    use_psum=use_psum, monoid=monoid,
                                    kernels=kernels, op_name=op_name)

    def fn(payload, valid):
        if isinstance(valid, Sharded):
            vblk = reshard(valid, "flat")
            ts = Sharded(mesh, "flat", {
                p: torch.zeros(v.shape[0], dtype=torch.int64,
                               device=v.device)
                for p, v in vblk.blocks.items()})
        else:
            ts = torch.zeros(valid.shape[0], dtype=torch.int64,
                             device=valid.device)
        table, _, has, _ = step(payload, ts, valid)
        return table, has
    fn.op_name = op_name
    return fn


# ---------------------------------------------------------------------------
# key-sharded FFAT windows
# ---------------------------------------------------------------------------

def _ffat_shard_layout(mesh: Mesh, capacity: int, K: int,
                       ingest: str = "data"):
    """Guards and layout shared by the key-sharded FFAT steps:
    ``(K_local, gather, batch_spec, step_cap)``, where ``gather`` turns
    per-position ``(payload, ts, valid)`` blocks into the lanes each key
    shard's local step sees (``step_cap`` of them).

    * ``"data"`` (single-process default): lanes split along ``data``;
      ``gather`` is one all_gather over ``data`` (nothing at data=1).
    * ``"flat"`` (multi-process graphs): lanes split over ``(data,
      key)``; ``gather`` rebuilds the logical lane order with an
      all_gather over ``key`` then ``data`` (the key hop crosses
      processes).
    * ``"aligned"`` (key-aligned ingest): lanes split over ``(data,
      key)`` with every tuple already on its key owner's column; the
      gather is the within-column data hop (nothing at data=1) and each
      key shard steps only its column's ``capacity/kk`` lanes."""
    kk, dd = mesh.shape[KEY_AXIS], mesh.shape[DATA_AXIS]
    if K % kk:
        raise WindFlowError(f"max_keys {K} not divisible by key axis {kk}")
    if capacity % dd:
        raise WindFlowError(
            f"capacity {capacity} not divisible by data axis {dd}")
    if ingest not in ("data", "flat", "aligned"):
        raise WindFlowError(f"unknown ffat ingest layout '{ingest}'")
    K_local = K // kk
    if ingest in ("flat", "aligned") and capacity % (dd * kk):
        raise WindFlowError(f"capacity {capacity} not divisible by the "
                            f"mesh's {dd * kk} devices")

    def over(axes_seq):
        def gather(P, T, V):
            for axes in axes_seq:
                P = _tree_collective(all_gather, P, mesh, axes)
                T = all_gather(T, mesh, axes)
                V = all_gather(V, mesh, axes)
            return P, T, V
        return gather

    data_hop = [DATA_AXIS] if dd > 1 else []
    if ingest == "flat":
        return K_local, over([KEY_AXIS] + data_hop), "flat", capacity
    if ingest == "aligned":
        return K_local, over(data_hop), "flat", capacity // kk
    return K_local, over(data_hop), "data", capacity


def _per_column(factory: Callable, mesh: Mesh, K_local: int) -> Dict[int,
                                                                      Callable]:
    """One local step per key column of this process, built by the
    single-device factory with that column's key base."""
    return {k: factory(k * K_local) for k in mesh.local_columns}


def make_sharded_ffat_step(mesh: Mesh, capacity: int, K: int, Pn: int, R: int,
                           D: int, lift: Callable, comb: Callable,
                           key_fn: Optional[Callable],
                           sum_like: bool = False,
                           grouping: str = "rank_scatter",
                           ingest: str = "data",
                           monoid: Optional[str] = None,
                           kernels: bool = False,
                           op_name: str = "mesh.ffat_step"):
    """One FFAT count-window step sharded over the mesh: ``fn(state,
    payload, ts, valid) -> (state, out, fired, out_ts)``.  Key shard
    ``k`` owns keys ``[k*K/kk, (k+1)*K/kk)``; each position gathers the
    batch (:func:`_ffat_shard_layout`) and runs the single-device step
    with its key base.  ``state`` is a key-sharded :class:`Sharded`
    value (:func:`make_sharded_ffat_state`); the fired windows come back
    in key-shard order."""
    from windflow_tpu_torch.windows.ffat_kernels import make_ffat_step
    if sum_like and monoid is None:
        monoid = "sum"
    K_local, gather, bspec, step_cap = _ffat_shard_layout(mesh, capacity, K,
                                                          ingest)
    steps = _per_column(lambda base: make_ffat_step(
        step_cap, K_local, Pn, R, D, lift, comb, key_fn, monoid=monoid,
        kernels=kernels, grouping=grouping, key_base=base), mesh, K_local)

    def fn(state, payload, ts, valid):
        P, T, V = gather(_tree_blocks(payload, mesh, bspec),
                         _blocks(ts, mesh, bspec), _blocks(valid, mesh, bspec))
        new, outs, fired, ots = {}, {}, {}, {}
        for pos in mesh.local_positions:
            new[pos], outs[pos], fired[pos], ots[pos] = steps[pos[1]](
                state.blocks[pos], P[pos], T[pos], V[pos])
        return (Sharded(mesh, "key", new),
                assemble(Sharded(mesh, "key", outs)),
                assemble(Sharded(mesh, "key", fired)),
                assemble(Sharded(mesh, "key", ots)))
    fn.op_name = op_name
    return fn


def make_sharded_ffat_flush(mesh: Mesh, K: int, Pn: int, R: int, D: int,
                            comb: Callable,
                            op_name: str = "mesh.ffat_flush"):
    """EOS flush of the key-sharded CB state: each key shard flushes its
    own rows (keys shifted by its base); ``fn(state) -> (out, fired,
    ts)`` in key-shard order, so each process reads its own keys."""
    from windflow_tpu_torch.windows.ffat_kernels import make_ffat_flush
    kk = mesh.shape[KEY_AXIS]
    if K % kk:
        raise WindFlowError(f"max_keys {K} not divisible by key axis {kk}")
    K_local = K // kk
    flushes = _per_column(lambda base: make_ffat_flush(
        K_local, Pn, R, D, comb, key_base=base), mesh, K_local)

    def fn(state):
        d0 = mesh.local_positions[0][0]
        outs, fired, tss = {}, {}, {}
        for pos in mesh.local_positions:
            if pos[0] != d0:
                continue
            outs[pos], fired[pos], tss[pos] = flushes[pos[1]](
                state.blocks[pos])
        # the data rows hold equal state: one row's flush is the output
        return tuple(assemble(Sharded(mesh, "key", g))
                     for g in (outs, fired, tss))
    fn.op_name = op_name
    return fn


def make_sharded_ffat_state(agg_spec, K: int, R: int, mesh: Mesh) -> Sharded:
    """The dense FFAT state, key-sharded: each position holds its key
    shard's ``K/kk`` rows on its device."""
    from windflow_tpu_torch.windows.ffat_kernels import make_ffat_state
    kk = mesh.shape[KEY_AXIS]
    if K % kk:
        raise WindFlowError(f"max_keys {K} not divisible by key axis {kk}")
    return Sharded(mesh, "key", {
        pos: make_ffat_state(agg_spec, K // kk, R,
                             device=mesh.device_of(pos))
        for pos in mesh.local_positions})


# The single-device TB state keeps scalar pane clocks shared by its keys;
# key-sharded, each shard's ring evolves on its own, so the scalars become
# one lane per key shard (each shard's 0-d element).
TB_SCALARS = ("base", "win_next", "max_seen", "n_late", "n_evicted",
              "n_win_dropped")


def make_sharded_ffat_tb_state(agg_spec, K: int, NP: int,
                               mesh: Mesh) -> Sharded:
    """The TB pane-ring state, key-sharded: each position holds its key
    shard's rows and its own 0-d ring clock (a ``[key shards]`` lane
    assembled)."""
    from windflow_tpu_torch.windows.ffat_kernels import make_ffat_tb_state
    kk = mesh.shape[KEY_AXIS]
    if K % kk:
        raise WindFlowError(f"max_keys {K} not divisible by key axis {kk}")
    return Sharded(mesh, "key", {
        pos: make_ffat_tb_state(agg_spec, K // kk, NP,
                                device=mesh.device_of(pos))
        for pos in mesh.local_positions})


def make_sharded_ffat_tb_step(mesh: Mesh, capacity: int, K: int, P_usec: int,
                              R: int, D: int, NP: int, lift: Callable,
                              comb: Callable, key_fn: Optional[Callable],
                              drop_tainted: bool = False,
                              grouping: str = "rank_scatter",
                              ingest: str = "data",
                              sum_like: bool = False,
                              monoid: Optional[str] = None,
                              kernels: bool = False,
                              op_name: str = "mesh.ffat_tb_step"):
    """One time-window FFAT step sharded over the mesh: ``fn(state,
    payload, ts, valid, wm_pane) -> (state, out, fired, out_ts,
    n_advanced)``; the layout of :func:`make_sharded_ffat_step`, each key
    shard with its own pane-ring clock, the watermark frontier passed to
    every position.  ``n_advanced`` is the windows advanced summed over
    the key shards (a psum over ``key``; along ``data`` it is already
    equal)."""
    from windflow_tpu_torch.windows.ffat_kernels import make_ffat_tb_step
    if sum_like and monoid is None:
        monoid = "sum"
    K_local, gather, bspec, step_cap = _ffat_shard_layout(mesh, capacity, K,
                                                          ingest)
    # the per-shard steps keep the plain fold route (fold, then the
    # no_fold zeros selected on the device): no conditional node yet
    steps = _per_column(lambda base: make_ffat_tb_step(
        step_cap, K_local, P_usec, R, D, NP, lift, comb, key_fn,
        drop_tainted=drop_tainted, monoid=monoid, kernels=kernels,
        grouping=grouping, key_base=base, cond=False), mesh, K_local)

    def fn(state, payload, ts, valid, wm_pane):
        P, T, V = gather(_tree_blocks(payload, mesh, bspec),
                         _blocks(ts, mesh, bspec), _blocks(valid, mesh, bspec))
        new, outs, fired, ots, adv = {}, {}, {}, {}, {}
        for pos in mesh.local_positions:
            wm = wm_pane.to(mesh.device_of(pos)) \
                if isinstance(wm_pane, torch.Tensor) else wm_pane
            new[pos], outs[pos], fired[pos], ots[pos], adv[pos] = \
                steps[pos[1]](state.blocks[pos], P[pos], T[pos], V[pos], wm)
        n_adv = psum(adv, mesh, KEY_AXIS)
        return (Sharded(mesh, "key", new),
                assemble(Sharded(mesh, "key", outs)),
                assemble(Sharded(mesh, "key", fired)),
                assemble(Sharded(mesh, "key", ots)),
                assemble(Sharded(mesh, "rep", n_adv)))
    fn.op_name = op_name
    return fn


# ---------------------------------------------------------------------------
# key-sharded stateful Map/Filter
# ---------------------------------------------------------------------------

def make_sharded_stateful_step(mesh: Mesh, capacity: int, S: int,
                               body_factory: Callable,
                               key_fn: Callable, dense: bool,
                               is_filter: bool, ingest: str = "data",
                               op_name: str = "mesh.stateful_step"):
    """Key-sharded stateful Map/Filter step ``fn(state, payload, valid,
    uniq_keys, uniq_slots) -> (state, payload, valid)``: the dense
    ``[S, ...]`` table split along ``key``.  The data-sharded batch is
    gathered over ``data``; each key shard runs the per-key in-order body
    (``body_factory(capacity, S_local)``) over the lanes whose slot it
    owns, and lane results merge across key shards with one ``psum``
    (each lane has exactly one owner).  Outputs return data-sharded
    (assembled in lane order).  ``uniq_keys``/``uniq_slots`` are the
    interning route's sorted tables (ignored with ``dense``).

    ``ingest="aligned"`` (dense slots only): each key shard's lanes are
    exactly the lanes it owns, so neither the data gather nor the psum
    merge runs; outputs stay in the aligned flat layout."""
    kk, dd = mesh.shape[KEY_AXIS], mesh.shape[DATA_AXIS]
    if S % kk:
        raise WindFlowError(
            f"num_key_slots {S} not divisible by key axis {kk}")
    if capacity % dd:
        raise WindFlowError(
            f"capacity {capacity} not divisible by data axis {dd}")
    S_local = S // kk
    blk = capacity // dd
    if ingest not in ("data", "aligned"):
        raise WindFlowError(f"unknown stateful ingest layout '{ingest}'")
    if ingest == "aligned":
        if not dense:
            raise WindFlowError(
                "key-aligned stateful ingest requires withDenseKeys")
        if capacity % (dd * kk):
            raise WindFlowError(
                f"capacity {capacity} not divisible by the mesh's "
                f"{dd * kk} devices (key-aligned ingest)")
        col_cap = capacity // kk
        blk_col = capacity // (dd * kk)
        body_a = body_factory(col_cap, S_local)

        def fn_aligned(state, payload, valid, _uk=None, _us=None):
            P = _tree_blocks(payload, mesh, "flat")
            V = _blocks(valid, mesh, "flat")
            if dd > 1:
                P = _tree_collective(all_gather, P, mesh, DATA_AXIS)
                V = all_gather(V, mesh, DATA_AXIS)
            new, outs, oks = {}, {}, {}
            for pos in mesh.local_positions:
                keys = _keys_of(key_fn, P[pos], col_cap, V[pos].device)
                lslot = keys - pos[1] * S_local
                owned = V[pos] & (keys >= 0) & (keys < S) & (lslot >= 0) \
                    & (lslot < S_local)
                lslot = torch.where(owned, lslot,
                                    torch.full_like(lslot, S_local))
                new[pos], out_p, out_v = body_a(state.blocks[pos], P[pos],
                                                owned, lslot)
                d = pos[0] * blk_col
                sl = lambda a: a[d:d + blk_col]  # noqa: E731
                if is_filter:
                    outs[pos] = tree_map(sl, P[pos])
                    oks[pos] = sl(out_v) & sl(owned)
                else:
                    outs[pos] = tree_map(sl, out_p)
                    oks[pos] = sl(owned)
            return (Sharded(mesh, "key", new),
                    assemble(Sharded(mesh, "flat", outs)),
                    assemble(Sharded(mesh, "flat", oks)))
        fn_aligned.op_name = op_name
        return fn_aligned
    body = body_factory(capacity, S_local)

    def fn(state, payload, valid, uniq_keys=None, uniq_slots=None):
        P = _tree_blocks(payload, mesh, "data")
        V = _blocks(valid, mesh, "data")
        if dd > 1:
            P = _tree_collective(all_gather, P, mesh, DATA_AXIS)
            V = all_gather(V, mesh, DATA_AXIS)
        new, outs, owned_b, valid_b, keep_b = {}, {}, {}, {}, {}
        for pos in mesh.local_positions:
            dev = V[pos].device
            keys = _keys_of(key_fn, P[pos], capacity, dev)
            if dense:
                slots = keys
                ok = V[pos] & (keys >= 0) & (keys < S)
            else:
                uk, us = uniq_keys.to(dev), uniq_slots.to(dev)
                ix = torch.clamp(torch.searchsorted(uk, keys), 0,
                                 capacity - 1)
                slots = us[ix]
                ok = V[pos] & (slots < S)
            lslot = slots - pos[1] * S_local
            owned = ok & (lslot >= 0) & (lslot < S_local)
            lslot = torch.where(owned, lslot, torch.full_like(lslot, S_local))
            new[pos], out_p, out_v = body(state.blocks[pos], P[pos], owned,
                                          lslot)
            # back to this data row's block first: the key-axis psum and
            # the slice commute, and slicing divides its volume by dd
            d = pos[0] * blk
            sl = lambda a: a[d:d + blk]  # noqa: E731
            owned_b[pos], valid_b[pos] = sl(owned), sl(V[pos])
            if is_filter:
                outs[pos] = tree_map(sl, P[pos])
                keep_b[pos] = (~(sl(out_v) | ~sl(owned))).to(torch.int32)
            else:
                outs[pos] = tree_map(
                    lambda a: torch.where(
                        _bcast(sl(owned), a), sl(a),
                        torch.zeros((), dtype=a.dtype, device=a.device)),
                    out_p)
        owned_any = psum({p: o.to(torch.int32) for p, o in owned_b.items()},
                         mesh, KEY_AXIS)
        if is_filter:
            vetoed = psum(keep_b, mesh, KEY_AXIS)
            oks = {p: valid_b[p] & (owned_any[p] > 0) & ~(vetoed[p] > 0)
                   for p in valid_b}
        else:
            # a bool field rides the psum as int32, and comes back bool
            merged = _tree_collective(psum, {
                p: tree_map(lambda a: a.to(torch.int32)
                            if a.dtype == torch.bool else a, o)
                for p, o in outs.items()}, mesh, KEY_AXIS)
            outs = {p: tree_map(lambda m, ref: m > 0
                                if ref.dtype == torch.bool else m,
                                merged[p], outs[p]) for p in outs}
            oks = {p: valid_b[p] & (owned_any[p] > 0) for p in valid_b}
        return (Sharded(mesh, "key", new),
                assemble(Sharded(mesh, "data", outs)),
                assemble(Sharded(mesh, "data", oks)))
    fn.op_name = op_name
    return fn


def _bcast(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (ref.ndim - 1))
