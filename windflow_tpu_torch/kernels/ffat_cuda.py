"""Hand-written CUDA kernels for the FFAT hot loop: wrappers, plain torch
versions, gates and counters.

The port of the two Pallas kernels of ``windflow_tpu/kernels/
pallas_ffat.py`` that the count-window path runs:

* :func:`grouping_rank_hist` / :func:`order_hist` — arrival-stable rank,
  histogram and counting-sort destinations of dense int ids
  (``csrc/grouping_rank_hist.cu``);
* :func:`sliding_fold` — the declared-monoid pane fold
  ``out[k, i] = fold(op, values[k, i-R+1..i])``, up to four leaves a
  launch (``csrc/sliding_fold.cu``).

Each wrapper takes its kernel's plain torch version for a tensor on the
CPU — the role ``interpret=True`` plays for Pallas — and for a CUDA
tensor launches the kernel or raises: there is no fallback.  Both
kernels are exact (integer arithmetic; the fold evaluates the plain
fold's own combine tree), so kernel and plain version agree bit for bit.

``Config.cuda_kernels`` resolves here (:func:`resolve_kernels`):
``"auto"`` and ``"1"`` route the FFAT step through these wrappers;
``"0"`` is the kill switch — the torch composition of
``windows/grouping.py`` and ``windows/ffat_kernels.py`` runs and no
wrapper is entered.  The third kernel, ``dense_monoid_table``, lives in
``reduce_cuda.py``, the stateful wavefront's device loop,
``wavefront_loop``, in ``loop_cuda.py``, and the steering kernel of the
port's ``lax.cond``, ``cond_select``, in ``cond_cuda.py``; all share the
counters below.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Optional

import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                           tree_unflatten)

#: lanes per tile of the grouping kernel (its TILE)
GROUP_TILE = 2048
#: bucket-space ceiling of the grouping kernel (the Pallas gate)
MAX_BUCKETS = 4096
#: lane-count ceiling of the grouping kernel (the Pallas gate)
MAX_LANES = 1 << 22
#: window-width ceiling of the fold kernel
MAX_FOLD_R = 512
#: pane-axis ceiling of the fold kernel (panes + R - 1): the grid rows of
#: its shared-memory path (65,535 blocks of 256 columns).  The Pallas
#: kernel's 4,096-pane VMEM block has no counterpart here: the register
#: path walks [K, panes] flat with 64-bit offsets
MAX_FOLD_PANES = 65535 * 256
#: leaves the fold kernel takes in one launch
FOLD_LEAVES = 4
#: outputs a thread of the fold kernel's register path: 8, or 4 or 16
#: at R = 8 only (compiled for chip_profile.py's fold-tile phase)
FOLD_RUN = 8

_MONOID_CODE = {"sum": 0, "max": 1, "min": 2}

#: wrapper entries since import (either route) — the kill switch must
#: enter none
_BUILD_COUNT = 0
#: kernel launches per wrapper since the last reset.  A wrapper counts
#: the launch it makes; a call made while a CUDA graph captures launches
#: nothing then, and counts once a replay (:class:`CountedGraph`)
_LAUNCHES = {"grouping_rank_hist": 0, "sliding_fold": 0,
             "dense_monoid_table": 0, "wavefront_loop": 0,
             "cond_select": 0}


#: kernel gates that held since import, keyed as :data:`_LAUNCHES`
#: (``grouping_supported``, ``fold_supported``,
#: ``reduce_cuda.table_supported`` returning True; the stateful
#: wavefront taking its device loop, ``ops/gpu_stateful.py``; a branching
#: region taking its conditional node, ``kernels/cond_cuda.py``): the
#: capture audit reads each kernel's delta over a recorded step beside its
#: launches (WF907)
_GATES_OPEN = dict.fromkeys(_LAUNCHES, 0)


def kernel_build_count() -> int:
    return _BUILD_COUNT


def gates_open() -> dict:
    return dict(_GATES_OPEN)


def _gate(name: str, ok: bool) -> bool:
    """Count kernel ``name``'s gate if it held; return it."""
    if ok:
        _GATES_OPEN[name] += 1
    return ok


def note_entry() -> None:
    """Count one wrapper entry (either route)."""
    global _BUILD_COUNT
    _BUILD_COUNT += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` (called by ``_launch`` after the C
    entry point returned success)."""
    _LAUNCHES[name] += 1


#: set on this thread inside :func:`uncounted`
_quiet = threading.local()


@contextlib.contextmanager
def uncounted():
    """Launches inside leave the counters as they were: a graph's warm-up
    on scratch data (``megastep.py``) runs kernels that serve no batch.
    The device counters of the stateful steps (:func:`counting`) skip it
    too."""
    before = launch_counts()
    was = getattr(_quiet, "on", False)
    _quiet.on = True
    try:
        yield
    finally:
        _quiet.on = was
        _LAUNCHES.update(before)


def counting() -> bool:
    """False inside :func:`uncounted` on this thread."""
    return not getattr(_quiet, "on", False)


#: held by every capture (``CountedGraph.capture``) and by readers on
#: other threads that touch the card (``monitoring/monitor.py``), so the
#: two never overlap
capture_lock = threading.Lock()
#: the CountedGraph this thread is capturing (``current_capture``)
_capturing = threading.local()


def current_capture():
    """The :class:`CountedGraph` whose capture this thread is inside, or
    None (the wavefront's device loop attaches its body pool to it)."""
    return getattr(_capturing, "graph", None)


class CountedGraph:
    """A captured CUDA graph and the kernel launches it holds.

    The wrappers count Python calls, so a replay would launch the
    captured kernels uncounted, and the capture itself would count
    launches that did not run.  ``capture(ctx)`` runs the capture
    context ``ctx`` (a ``torch.cuda.graph``), records the calls made
    inside it on ``self.launches`` and takes them back off the counters;
    every ``replay()`` adds them again."""

    def __init__(self, graph) -> None:
        self.graph = graph
        #: kernel name -> calls captured (launched once a replay)
        self.launches = {}
        #: objects that must live as long as the graph (the memory pool
        #: of a device loop's bodies, ``kernels/loop_cuda.py``)
        self.keep = []

    @contextlib.contextmanager
    def capture(self, ctx):
        # another thread touching the card mid-capture (the monitoring
        # thread's stats read) invalidates it: such readers hold the lock
        with capture_lock:
            before = launch_counts()
            # a dead graph left in a reference cycle (an earlier run's
            # group) resets when the collector frees it, and a reset while
            # this stream captures invalidates the capture: collect now,
            # and hold the automatic collector off until the capture ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            _capturing.graph = self
            try:
                with ctx:
                    yield self
            finally:
                _capturing.graph = None
                if collecting:
                    gc.enable()
                after = launch_counts()
                self.launches = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
                for k, v in self.launches.items():
                    _LAUNCHES[k] -= v

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.launches.items():
            _LAUNCHES[k] += v

    def launches_per_replay(self) -> int:
        return sum(self.launches.values())


def resolve_kernels(config) -> bool:
    """``Config.cuda_kernels`` -> whether the FFAT and reduce steps go
    through the kernel wrappers ("auto" and "1": yes; "0": no).  The device is
    decided per tensor by the wrappers."""
    raw = getattr(config, "cuda_kernels", "auto")
    mode = {True: "1", False: "0"}.get(raw, str(raw).strip().lower())
    if mode in ("0", "off", "false"):
        return False
    if mode in ("1", "on", "true", "auto"):
        return True
    raise WindFlowError(
        f"Config.cuda_kernels must be 'auto', '1' or '0', got {raw!r}")


def kernels_forced(config) -> bool:
    """True when the user forced the kernels on (``cuda_kernels="1"``):
    the only mode whose downgrades preflight names (WF607); "auto" picks
    silently."""
    raw = getattr(config, "cuda_kernels", "auto")
    mode = {True: "1", False: "0"}.get(raw, str(raw).strip().lower())
    return mode in ("1", "on", "true", "force")


def monoid_identity(kind: str, dtype: torch.dtype):
    """The identity of a declared monoid for one dtype, as a Python
    scalar."""
    if kind == "sum":
        return False if dtype == torch.bool else 0
    if dtype == torch.bool:
        return kind == "min"
    if dtype.is_floating_point:
        return float("-inf") if kind == "max" else float("inf")
    info = torch.iinfo(dtype)
    return int(info.min if kind == "max" else info.max)


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.device.type != "cuda":
        raise WindFlowError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise WindFlowError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise WindFlowError(f"{name}: expected {ndim}-D, got {t.shape}")
    if not t.is_contiguous():
        raise WindFlowError(f"{name}: tensor must be contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    from windflow_tpu_torch.kernels import build
    fn = build.entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise WindFlowError(f"{name}: CUDA error {rc} at launch")
    count_launch(name)


# ---------------------------------------------------------------------------
# kernel 1: segmented grouping — rank + histogram + counting-sort dests
# ---------------------------------------------------------------------------

def grouping_supported(n: int, nbuckets: int) -> bool:
    """The Pallas gate, kept as is: outside it the torch counting path
    keeps the job (bit-identical either way)."""
    return _gate("grouping_rank_hist",
                 2 <= nbuckets <= MAX_BUCKETS and 0 < n <= MAX_LANES)


def grouping_rank_hist_plain(ids: torch.Tensor, nbuckets: int):
    """Plain torch version of :func:`grouping_rank_hist` (the composition
    the kernel replaces): ``dense_rank`` and the bucket starts."""
    from windflow_tpu_torch.windows.grouping import dense_rank
    B = ids.shape[0]
    rank_p, counts, _, _ = dense_rank(ids, nbuckets)
    rank = rank_p[:B]
    start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    dest = start[ids.long()] + rank
    return dest, rank, counts


def grouping_rank_hist(ids: torch.Tensor, nbuckets: int):
    """``(dest, rank, hist)`` for int32 ids in ``[0, nbuckets)`` (callers
    pre-clamp): ``rank[i]`` is lane i's arrival-stable rank among equal
    ids, ``hist[b]`` the occurrences of ``b``, ``dest[i] =
    bucket_start[id_i] + rank[i]`` the stable counting-sort destination.
    All int32."""
    note_entry()
    if ids.device.type == "cpu":
        return grouping_rank_hist_plain(ids, nbuckets)
    _check(ids, "grouping_rank_hist ids", (torch.int32,), 1)
    B, NB = int(ids.shape[0]), int(nbuckets)
    if not grouping_supported(B, NB):
        raise WindFlowError(
            f"grouping_rank_hist: {B} lanes / {NB} buckets outside the "
            "kernel gate (grouping_supported)")
    dev = ids.device
    i32 = dict(dtype=torch.int32, device=dev)
    dest = torch.empty(B, **i32)
    rank = torch.empty(B, **i32)
    hist = torch.empty(NB, **i32)
    tilecnt = torch.empty(-(-B // GROUP_TILE) * NB, **i32)
    _launch("grouping_rank_hist", dev, ids.data_ptr(), B, NB,
            dest.data_ptr(), rank.data_ptr(), hist.data_ptr(),
            tilecnt.data_ptr())
    return dest, rank, hist


def order_hist(ids: torch.Tensor, nbuckets: int):
    """Kernel twin of ``grouping.order_and_hist``: the stable grouping
    permutation (one scatter inverts the destinations) plus the
    histogram."""
    from windflow_tpu_torch.windows.grouping import invert_perm
    dest, _, hist = grouping_rank_hist(ids, nbuckets)
    return invert_perm(dest), hist


# ---------------------------------------------------------------------------
# kernel 2: pane combine / sliding fold
# ---------------------------------------------------------------------------

def fold_supported(values, R: int, monoid: Optional[str]) -> bool:
    """Gate for the fold kernel: declared monoid, 2-D ``[K, panes]``
    leaves, f32/i32 (the compiled TPU gate), 1 <= R <= 512 and
    panes + R - 1 <= :data:`MAX_FOLD_PANES`."""
    if monoid not in _MONOID_CODE or not (1 <= R <= MAX_FOLD_R):
        return False
    leaves = tree_leaves(values)
    if not leaves or not all(l.ndim == 2 for l in leaves):
        return False
    if int(leaves[0].shape[1]) + (R - 1) > MAX_FOLD_PANES:
        return False
    return _gate("sliding_fold", all(l.dtype in (torch.float32, torch.int32)
                                     for l in leaves))


def _shift_cols(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Shift a [K, N] tensor right by ``k`` columns, filling with
    ``fill``."""
    if k == 0:
        return x
    n = x.shape[1]
    pad = torch.full((x.shape[0], min(k, n)), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[:, :n - k]], 1) if k < n else pad


def fold_leaf_plain(x: torch.Tensor, valid: torch.Tensor, R: int,
                    monoid: str) -> torch.Tensor:
    """Plain torch version of the fold kernel for one leaf: identity fill,
    then ``_sliding_reduce_plain``'s schedule (pow2 doubling + binary
    stitching from the newest end)."""
    ident = monoid_identity(monoid, x.dtype)
    filled = torch.where(valid, x, ident)
    op = {"sum": torch.add, "max": torch.maximum,
          "min": torch.minimum}[monoid]
    pow2 = [filled]
    width = 1
    while width * 2 <= R:
        v = pow2[-1]
        pow2.append(op(_shift_cols(v, width, ident), v))
        width *= 2
    res = None
    offset = 0
    for j in range(len(pow2) - 1, -1, -1):
        w = 1 << j
        if R & w:
            v = _shift_cols(pow2[j], offset, ident)
            res = v if res is None else op(v, res)
            offset += w
    return res


def sliding_fold(values, valid: torch.Tensor, R: int, monoid: str):
    """``out[k, i] = fold(monoid-op, values[k, i-R+1..i])`` for every leaf
    of the ``[K, panes]`` pytree ``values``, invalid panes absorbed as the
    monoid identity.  On the card up to :data:`FOLD_LEAVES` leaves, f32
    and i32 mixed, fold in one launch that reads the mask once (further
    leaves take further launches); CPU leaves take the plain version one
    at a time."""
    note_entry()
    leaves, treedef = tree_flatten(values)
    if all(l.device.type == "cpu" for l in leaves):
        return tree_unflatten(treedef, [fold_leaf_plain(l, valid, R, monoid)
                                        for l in leaves])
    _check(valid, "sliding_fold valid", (torch.bool,), 2)
    for l in leaves:
        _check(l, "sliding_fold values", (torch.float32, torch.int32), 2)
        if l.shape != valid.shape or l.device != valid.device:
            raise WindFlowError(
                f"sliding_fold: values {tuple(l.shape)} on {l.device} vs "
                f"valid {tuple(valid.shape)} on {valid.device}")
    K, NPP = int(valid.shape[0]), int(valid.shape[1])
    if monoid not in _MONOID_CODE or not (1 <= R <= MAX_FOLD_R) \
            or NPP + R - 1 > MAX_FOLD_PANES:
        raise WindFlowError(
            f"sliding_fold: monoid {monoid!r}, R={R}, {NPP} panes outside "
            "the kernel gate (fold_supported)")
    outs = [torch.empty_like(l) for l in leaves]
    for i in range(0, len(leaves), FOLD_LEAVES):
        group, ogroup = leaves[i:i + FOLD_LEAVES], outs[i:i + FOLD_LEAVES]
        pad = [0] * (FOLD_LEAVES - len(group))
        int_mask = sum(1 << j for j, l in enumerate(group)
                       if l.dtype == torch.int32)
        _launch("sliding_fold", valid.device, valid.data_ptr(),
                *[l.data_ptr() for l in group], *pad,
                *[o.data_ptr() for o in ogroup], *pad, len(group), int_mask,
                K, NPP, int(R), _MONOID_CODE[monoid], int(FOLD_RUN))
    return tree_unflatten(treedef, outs)
