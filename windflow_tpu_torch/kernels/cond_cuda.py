"""The port's ``lax.cond``: ``csrc/cond_select.cu``'s wrapper, its plain
version, and a CUDA graph SWITCH node whose bodies are the branches.

The counterpart of the JAX package's two device-side ``jax.lax.cond``
calls (no Pallas kernel): the TB window step's fold, run only on a fire
pass that fires (``windflow_tpu/windows/ffat_kernels.py:733``), and the
compacted reduce's overflow branches (``windflow_tpu/parallel/
compaction.py:465-467``).  The branch index stays a device scalar:

* :func:`cond_select` — one thread, the node's steering: reads the
  index, sets the SWITCH handle to it (to "no body" when it is out of
  range) and counts the pick on the device (:func:`body_counts`).
  :func:`cond_select_plain` is its plain version on host tensors;
* :func:`emit_switch` — inside a capture (``kernels.ffat_cuda.
  CountedGraph``), the launch of :func:`cond_select`, then one SWITCH
  node whose body j is captured from ``bodies[j]()`` on a side stream,
  the body allocations routed to the capturing graph's
  ``loop_cuda.LoopPool``.  The node and its bodies are made by the
  conditional-node entry points of ``csrc/wavefront_loop.cu``
  (``kernels/loop_cuda.py``'s helpers), which the wavefront's loop uses;
* :func:`switch` — the call a branching region makes: the node inside a
  capture, every body in a graph's warm-up, the plain version on host
  tensors (a host read of the index: the CPU's route);
* :class:`RegionGraph` — a region holding such nodes, run outside a
  capture as a cached standalone CUDA graph over static buffers (one a
  device and input signature), replayed a call, its outputs cloned out;
  inside a capture (a megastep's) it runs inline.

A body writes into buffers allocated before the node: the node's
outputs are those buffers whatever body ran.

Counters: ``ffat_cuda``'s ``cond_select`` counts one launch a node run
(a replay adds it again, as for every captured kernel); the picks are
counted on the device, by site and body, in a per-device table
(:func:`body_counts`; the last column counts "no body").
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, List, Optional, Sequence

import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.kernels import loop_cuda
from windflow_tpu_torch.utils.tree import tree_flatten, tree_unflatten

#: the kernel's name in the launch and gate counters
NAME = "cond_select"
#: most bodies of one node (a row of the counter table is this + 1)
MAX_BODIES = 8
#: most distinct sites the counter table holds
MAX_SITES = 16

#: per-device counter tables (int64 [MAX_SITES, MAX_BODIES + 1])
_counts = {}
#: site name -> row of the counter tables
_sites = {}
#: per-device side stream the bodies are captured on
_streams = {}
_state_lock = threading.Lock()
#: this thread is warming a region up (:class:`RegionGraph`)
_local = threading.local()
#: standalone RegionGraph replays since import: each is one
#: cudaGraphLaunch besides a megastep's
_REPLAYS = 0


def standalone_replays() -> int:
    """Replays of the standalone region graphs since import (host
    counter): the ``cudaGraphLaunch`` calls a run makes besides one a
    megastep."""
    return _REPLAYS


def _site_row(site: str) -> int:
    row = _sites.get(site)
    if row is None:
        with _state_lock:
            row = _sites.setdefault(site, len(_sites))
        if row >= MAX_SITES:
            raise WindFlowError(f"cond_select: more than {MAX_SITES} sites")
    return row


def _table(device: torch.device) -> torch.Tensor:
    tbl = _counts.get(device)
    if tbl is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise WindFlowError("cond_select: prepare(device) must run "
                                "before the first capture")
        tbl = torch.zeros((MAX_SITES, MAX_BODIES + 1), dtype=torch.int64,
                          device=device)
        _counts[device] = tbl
    return tbl


def _counter(device, site: Optional[str]) -> Optional[torch.Tensor]:
    if site is None:
        return None
    return _table(loop_cuda._device(device))[_site_row(site)]


def body_counts(device, site: str, nbodies: int) -> List[int]:
    """How often each body of ``site``'s nodes ran on ``device`` since the
    table was made or :func:`reset_body_counts`, then the runs that took
    no body: ``nbodies + 1`` ints (a host read: cold path)."""
    tbl = _counts.get(loop_cuda._device(device))
    if tbl is None or site not in _sites:
        return [0] * (nbodies + 1)
    # wfverify: ok (a cold-path counter read, never in a step)
    row = tbl[_sites[site]].tolist()
    return row[:nbodies] + [sum(row[nbodies:])]


def reset_body_counts(device) -> None:
    tbl = _counts.get(loop_cuda._device(device))
    if tbl is not None:
        tbl.zero_()


def prepare(device) -> None:
    """Make the counter table and the side stream of ``device``, and the
    wavefront loop's (outside any capture: a stream is not made while
    one runs)."""
    device = loop_cuda._device(device)
    loop_cuda.prepare(device)
    with _state_lock:
        _table(device)
        if device not in _streams:
            from windflow_tpu_torch.kernels import build
            make = build.entry(loop_cuda.NAME, "wf_body_stream")
            p = ctypes.c_void_p()
            with torch.cuda.device(device):
                rc = make(ctypes.byref(p))
            if rc != 0:
                raise WindFlowError(f"cond_select: stream creation failed "
                                    f"(CUDA error {rc})")
            _streams[device] = torch.cuda.ExternalStream(p.value,
                                                         device=device)


def _check_index(index: torch.Tensor) -> None:
    fc._check(index.reshape(-1), "cond_select index",
              (torch.int32, torch.int64), 1)
    if index.numel() != 1:
        raise WindFlowError(f"cond_select: the index is one scalar, got "
                            f"{tuple(index.shape)}")


def cond_select_plain(index: torch.Tensor, nbodies: int,
                      counts: Optional[torch.Tensor] = None) -> int:
    """Plain version of :func:`cond_select` on host tensors: the picked
    body (``nbodies`` for "no body"), counted in ``counts``."""
    i = int(index.tolist())
    pick = i if 0 <= i < nbodies else nbodies
    if counts is not None:
        counts[pick] += 1
    return pick


def cond_select(index: torch.Tensor, nbodies: int, *,
                site: Optional[str] = None, handle: Optional[int] = None,
                count: bool = True,
                stream: Optional[torch.cuda.Stream] = None) -> Optional[int]:
    """Pick the body of an ``nbodies``-body SWITCH node from the int32 or
    int64 scalar ``index``: body ``index`` when ``0 <= index < nbodies``,
    none otherwise; ``site`` counts the pick.  On the card one launch of
    the one-thread kernel on the current (or given) stream, which sets
    the SWITCH handle ``handle`` inside a capture; returns None.  CPU
    tensors take :func:`cond_select_plain` and return the pick."""
    fc.note_entry()
    if index.device.type == "cpu":
        return cond_select_plain(index, nbodies, _counter(index.device,
                                                          site))
    _check_index(index)
    if not 1 <= nbodies <= MAX_BODIES:
        raise WindFlowError(f"cond_select: {nbodies} bodies (1 to "
                            f"{MAX_BODIES})")
    from windflow_tpu_torch.kernels import build
    dev = loop_cuda._device(index.device)
    ctr = _counter(dev, site)
    fn = build.entry(NAME)
    with torch.cuda.device(dev):
        st = (stream if stream is not None
              else torch.cuda.current_stream(dev)).cuda_stream
        rc = fn(index.data_ptr(), int(index.dtype == torch.int64),
                int(nbodies), int(handle or 0), int(handle is not None),
                0 if ctr is None else ctr.data_ptr(), st)
    if rc != 0:
        raise WindFlowError(f"{NAME}: CUDA error {rc} at launch")
    if count:
        fc.count_launch(NAME)
    return None


def emit_switch(index: torch.Tensor, bodies: Sequence[Callable[[], None]],
                site: str) -> None:
    """Capture a SWITCH node into the graph the current stream is
    capturing (through ``ffat_cuda.CountedGraph.capture``): the
    :func:`cond_select` launch, then the node, body j ``bodies[j]()``:
    torch work on the current stream, writing into buffers allocated
    before the node."""
    graph = fc.current_capture()
    if graph is None or not torch.cuda.is_current_stream_capturing():
        raise WindFlowError("cond_select: emit_switch runs inside a "
                            "CountedGraph capture only")
    dev = loop_cuda._device(index.device)
    side = _streams.get(dev)
    if side is None:
        raise WindFlowError("cond_select: prepare(device) must run before "
                            "the first capture")
    parent = torch.cuda.current_stream(dev)
    h = loop_cuda.new_handle(parent)
    cond_select(index, len(bodies), site=site, handle=h)
    with loop_cuda.loop_pool(graph, dev).routing():
        graphs = loop_cuda.add_node(parent, h, loop_cuda._SWITCH,
                                    len(bodies))
        for body, body_graph in zip(bodies, graphs):
            with loop_cuda.capturing(side, body_graph):
                body()


def _warming() -> bool:
    return getattr(_local, "warming", False)


@contextlib.contextmanager
def warming():
    """Inside, :func:`switch` runs every body eagerly: a graph's warm-up
    before its capture (its launches serve no batch)."""
    prev = _warming()
    _local.warming = True
    try:
        yield
    finally:
        _local.warming = prev


def switch(index: torch.Tensor, bodies: Sequence[Callable[[], None]],
           site: str) -> None:
    """Run ``bodies[index]`` (none when ``index`` is out of range).  On
    the card the SWITCH node of :func:`emit_switch` inside a capture, and
    every body in a warm-up (:func:`warming`); anywhere else on the card
    it raises (:class:`RegionGraph` runs a region outside a capture).
    Host tensors take the plain version (a host read of the index)."""
    if index.device.type == "cpu":
        pick = cond_select(index, len(bodies), site=site)
        if pick < len(bodies):
            bodies[pick]()
        return
    if _warming():
        for body in bodies:
            body()
        return
    if not torch.cuda.is_current_stream_capturing():
        raise WindFlowError("cond_select: a switch on the card runs inside "
                            "a capture (RegionGraph or a megastep)")
    emit_switch(index, bodies, site)


def switch_plain(index: torch.Tensor,
                 bodies: Sequence[Callable[[], None]]) -> None:
    """The plain route of a branching region (``Config(cuda_kernels=
    "0")``): the index read on the host picks the body; no wrapper is
    entered."""
    # a host read (on the card a synchronising one, which the capture
    # audit names: WF906), by design of the plain route
    i = int(index.tolist())
    if 0 <= i < len(bodies):
        bodies[i]()


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class RegionGraph:
    """A region (``region(*args) -> outputs``, torch work holding
    :func:`switch` calls) run on the card with no host read.

    Outside a capture: a cached standalone ``CountedGraph`` a device,
    captured over static copies of the arguments after one eager warm-up
    of every body, rebuilt when the arguments' structure, dtypes or
    shapes change (a TB ring regrow); a call copies the arguments in,
    replays and clones the outputs out (the next replay overwrites the
    graph's).  Inside a capture, and on host tensors, the region runs
    as it is."""

    def __init__(self, name: str, region: Callable) -> None:
        self.name = name
        self.region = region
        #: device -> {"sig", "graph", "static", "outs"}
        self.cached = {}

    def __call__(self, *args):
        leaves, treedef = tree_flatten(args)
        tens = [l for l in leaves if _is_tensor(l)]
        if not tens or tens[0].device.type != "cuda" \
                or torch.cuda.is_current_stream_capturing():
            return self.region(*args)
        dev = loop_cuda._device(tens[0].device)
        sig = (treedef, tuple((l.dtype, tuple(l.shape)) if _is_tensor(l)
                              else l for l in leaves))
        c = self.cached.get(dev)
        if c is None or c["sig"] != sig:
            c = self._build(dev, leaves, treedef)
            c["sig"] = sig
        global _REPLAYS
        for s, a in zip(c["static"], leaves):
            if _is_tensor(a):
                s.copy_(a)
        c["graph"].replay()
        _REPLAYS += 1
        outs, odef = tree_flatten(c["outs"])
        return tree_unflatten(odef, [o.clone() if _is_tensor(o) else o
                                     for o in outs])

    def _build(self, dev, leaves, treedef) -> dict:
        prepare(dev)
        old = self.cached.pop(dev, None)
        if old is not None:
            old["graph"].graph.reset()
        static = [l.clone() if _is_tensor(l) else l for l in leaves]
        args = tree_unflatten(treedef, static)
        try:
            with fc.uncounted(), warming():
                self.region(*args)
            graph = fc.CountedGraph(torch.cuda.CUDAGraph())
            with graph.capture(loop_cuda.side_capture(graph.graph, dev)):
                outs = self.region(*args)
        except WindFlowError:
            raise
        except Exception as e:  # lint: broad-except-ok (re-raised with
            # the cause, naming the region)
            raise WindFlowError(
                f"{self.name}: capturing its conditional nodes as a CUDA "
                f"graph failed: {type(e).__name__}: {e}") from e
        c = {"graph": graph, "static": static, "outs": outs, "sig": None}
        self.cached[dev] = c
        return c
