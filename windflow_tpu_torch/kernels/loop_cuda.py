"""The stateful wavefront's device loop: ``csrc/wavefront_loop.cu``'s
wrapper, its plain version, and the capture of a CUDA graph WHILE node
whose body is a SWITCH node of width classes.  Its conditional-node
helpers (:func:`new_handle`, :func:`add_node`, :func:`capturing`,
:func:`loop_pool`) serve ``kernels/cond_cuda.py`` too.

The counterpart of the ``jax.lax.while_loop`` in
``windflow_tpu/ops/tpu_stateful.py`` ``_wavefront_body`` (no Pallas
kernel).  ``ops/gpu_stateful.py`` orders a batch's live lanes by (rank,
slot) and counts the lanes of each rank (``cnt``); the loop then runs
once a live rank with no host read:

* :func:`wavefront_advance` — one thread, the loop's steering (its
  cursor layout is the kernel's, :data:`CUR_WORDS` int64 words): rank
  r's slice of the ordered lanes, the smallest width class that holds
  it, and whether rank r + 1 is live.  :func:`advance_plain` is its
  plain version on host tensors;
* :func:`emit_loop` — inside a capture (``kernels.ffat_cuda.
  CountedGraph``), the launch before the node (reset, the loop's handle
  from ``cnt[0]``), then the WHILE node: ``wavefront_advance`` picks the
  width class and sets the handles of the class node (one SWITCH node,
  body j = class j) and of the loop, and the class body runs one
  window of the user function;
* :func:`run_loop_plain` — the same contract driven on the host by
  :func:`advance_plain` (the CPU tests' route to the class bodies).

The bodies are captured on side streams of their own, whose torch
allocations go to a memory pool that the capturing graph keeps alive
(:class:`LoopPool`): a WHILE body replays its buffers every pass, and
memory the caching allocator handed back to eager code would be
overwritten under it.

Counters: ``ffat_cuda``'s ``wavefront_loop`` counts one launch a loop
run, the reset launch that starts it (a replay adds it again, as for
every captured kernel); the passes (``wavefront_advance`` inside the
node, depth times a run) are counted on the device,
:func:`device_passes`.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, List, Optional

import torch

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc

#: the kernel's name in the launch and gate counters
NAME = "wavefront_loop"
#: the cursor's int64 words: r, off, base, count, more, cls
CUR_WORDS = 6
#: the narrowest width class (one warp)
MIN_WIDTH = 32
#: most width classes (the kernel's MAX_CLASSES)
MAX_CLASSES = 16
#: ``wf_cond_add`` node kinds
_WHILE, _SWITCH = 1, 2

#: per-device pass counters (int64 [1], on the card)
_passes = {}
#: per-device side streams (WHILE body, IF bodies), made outside captures
_streams = {}
#: per-device streams the standalone loop graphs are captured on
_capture_streams = {}
_state_lock = threading.Lock()


def width_classes(num_slots: int, capacity: int) -> List[int]:
    """The power-of-two window widths, descending, from the one that
    holds ``min(num_slots, capacity)`` lanes (a rank's most) down to
    :data:`MIN_WIDTH`: one body each of the loop's SWITCH node, and a
    rank runs the smallest that holds its lanes, so a pass does at most
    twice its live lanes' work, or MIN_WIDTH lanes."""
    most = max(1, min(int(num_slots), int(capacity)))
    top = 1 << (most - 1).bit_length()
    out = [top]
    while out[-1] > MIN_WIDTH:
        out.append(out[-1] // 2)
    if len(out) > MAX_CLASSES:
        raise WindFlowError(
            f"wavefront loop: {len(out)} width classes (at most "
            f"{MAX_CLASSES}) for {most} lanes a rank")
    return out


def pick_class(widths: List[int], count: int) -> int:
    """The index of the smallest width ``>= count`` (-1 for no lane)."""
    if count <= 0:
        return -1
    for j in range(len(widths) - 1, -1, -1):
        if widths[j] >= count:
            return j
    raise WindFlowError(f"wavefront loop: {count} lanes in one rank, "
                        f"wider than the widest class {widths[0]}")


def advance_plain(cnt: torch.Tensor, cur: torch.Tensor, widths: List[int],
                  reset: bool) -> None:
    """Plain version of :func:`wavefront_advance` on host tensors: the
    same cursor words, written in place."""
    cap = int(cnt.shape[0])
    if reset:
        c0 = int(cnt[0]) if cap else 0
        cur.copy_(torch.tensor([0, 0, 0, 0, int(c0 > 0), -1]))
        return
    r, off = int(cur[0]), int(cur[1])
    c = int(cnt[r]) if r < cap else 0
    nxt = int(cnt[r + 1]) if r + 1 < cap else 0
    cur.copy_(torch.tensor([r + 1, off + c, off, c, int(nxt > 0),
                            pick_class(widths, c)]))


def _check_args(cnt, cur):
    fc._check(cnt, "wavefront_advance cnt", (torch.int32,), 1)
    fc._check(cur, "wavefront_advance cur", (torch.int64,), 1)
    if cur.shape[0] != CUR_WORDS or cur.device != cnt.device:
        raise WindFlowError(
            f"wavefront_advance: cursor {tuple(cur.shape)} on {cur.device} "
            f"(want [{CUR_WORDS}] int64 on {cnt.device})")


def _device(device) -> torch.device:
    """``device`` with its index (the current card's for a bare "cuda")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def device_passes(device) -> int:
    """Passes ``wavefront_advance`` made on ``device`` since the counter
    was made or :func:`reset_device_passes` (a host read: cold path)."""
    buf = _passes.get(_device(device))
    # wfverify: ok (a cold-path counter read, never in a step)
    return 0 if buf is None else int(buf.item())


def reset_device_passes(device) -> None:
    buf = _passes.get(_device(device))
    if buf is not None:
        buf.zero_()


def _pass_counter(device: torch.device) -> torch.Tensor:
    buf = _passes.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise WindFlowError("wavefront loop: prepare(device) must run "
                                "before the first capture")
        buf = torch.zeros(1, dtype=torch.int64, device=device)
        _passes[device] = buf
    return buf


def prepare(device) -> None:
    """Make the pass counter and the side streams of ``device`` (outside
    any capture: a stream is not made while one runs)."""
    device = _device(device)
    with _state_lock:
        _pass_counter(device)
        if device not in _streams:
            from windflow_tpu_torch.kernels import build
            make = build.entry(NAME, "wf_body_stream")
            handles = []
            with torch.cuda.device(device):
                for _ in range(2):
                    p = ctypes.c_void_p()
                    rc = make(ctypes.byref(p))
                    if rc != 0:
                        raise WindFlowError(
                            f"wavefront loop: stream creation failed "
                            f"(CUDA error {rc})")
                    handles.append(torch.cuda.ExternalStream(
                        p.value, device=device))
            _streams[device] = tuple(handles)


@contextlib.contextmanager
def side_capture(graph, device):
    """Capture into ``graph`` (a ``torch.cuda.CUDAGraph``, its own private
    pool) on a side stream ordered after the current one.  Unlike
    ``torch.cuda.graph`` it does not synchronise the device or empty the
    cache first, so a step that captures its loop makes no host read."""
    device = _device(device)
    cur = torch.cuda.current_stream(device)
    side = _capture_streams.get(device)
    if side is None:
        side = torch.cuda.Stream(device=device)
        _capture_streams[device] = side
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            yield
        finally:
            graph.capture_end()
    cur.wait_stream(side)


def wavefront_advance(cnt: torch.Tensor, cur: torch.Tensor,
                      widths: List[int], reset: bool, *,
                      cls_handle: int = 0,
                      loop_handle: Optional[int] = None, count: bool = True,
                      stream: Optional[torch.cuda.Stream] = None) -> None:
    """One step of the loop's steering, in place on ``cur``: ``reset``
    zeroes it (``more`` from ``cnt[0]``); else it publishes rank r's
    slice and class and advances.  On the card one launch of the
    one-thread kernel on the current (or given) stream; with
    ``loop_handle`` (inside a capture) it also sets the WHILE handle and
    the classes' SWITCH handle ``cls_handle``.  CPU tensors take
    :func:`advance_plain`."""
    fc.note_entry()
    if cnt.device.type == "cpu":
        advance_plain(cnt, cur, widths, reset)
        return
    _check_args(cnt, cur)
    if not 1 <= len(widths) <= MAX_CLASSES:
        raise WindFlowError(f"wavefront_advance: {len(widths)} classes")
    from windflow_tpu_torch.kernels import build
    dev = cnt.device
    fn = build.entry(NAME)
    wid = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(dev):
        st = (stream if stream is not None
              else torch.cuda.current_stream(dev)).cuda_stream
        rc = fn(cnt.data_ptr(), int(cnt.shape[0]), cur.data_ptr(),
                _pass_counter(dev).data_ptr(), wid, len(widths),
                int(cls_handle), int(loop_handle or 0),
                int(loop_handle is not None), int(bool(reset)), st)
    if rc != 0:
        raise WindFlowError(f"{NAME}: CUDA error {rc} at launch")
    if count:
        fc.count_launch(NAME)


class LoopPool:
    """A private memory pool of the caching allocator that the loop
    bodies of one captured graph allocate from; it lives as long as that
    graph (``CountedGraph.keep``).  Every :meth:`routing` block routes
    the current thread's allocations to it and holds one reference,
    released when the graph goes."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device).index or 0
        self.id = torch.cuda.graph_pool_handle()
        self.uses = 0

    @contextlib.contextmanager
    def routing(self):
        try:
            begin = torch._C._cuda_beginAllocateCurrentThreadToPool
            end = torch._C._cuda_endAllocateToPool
        except AttributeError as e:
            raise WindFlowError(
                "wavefront loop: this torch has no allocator routing to a "
                f"graph pool ({e})") from e
        begin(self.device, self.id)
        self.uses += 1
        try:
            yield
        finally:
            end(self.device, self.id)

    def __del__(self):
        try:
            release = torch._C._cuda_releasePool
        except AttributeError:      # a torch without it, or teardown
            return
        for _ in range(self.uses):
            release(self.device, self.id)
        self.uses = 0


def loop_pool(graph, device) -> LoopPool:
    """The :class:`LoopPool` of ``device`` that ``graph`` (a
    ``CountedGraph``) keeps, made on first use."""
    for obj in graph.keep:
        if isinstance(obj, LoopPool) \
                and obj.device == (torch.device(device).index or 0):
            return obj
    pool = LoopPool(device)
    graph.keep.append(pool)
    return pool


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise WindFlowError(f"{NAME}: CUDA error {rc} building the loop")


def new_handle(stream) -> int:
    """A conditional handle of the graph ``stream`` is capturing into."""
    from windflow_tpu_torch.kernels import build
    h = ctypes.c_ulonglong()
    _call(build.entry(NAME, "wf_cond_handle"), stream.cuda_stream,
          ctypes.byref(h))
    return h.value


def add_node(stream, handle: int, kind: int, size: int) -> list:
    """A conditional node of ``kind`` (IF 0, :data:`_WHILE`,
    :data:`_SWITCH`) with ``size`` bodies, steered by ``handle``, after
    the work ``stream`` has captured so far; returns the body graphs."""
    from windflow_tpu_torch.kernels import build
    bodies = (ctypes.c_void_p * size)()
    _call(build.entry(NAME, "wf_cond_add"), stream.cuda_stream, handle,
          kind, size, bodies)
    return list(bodies)


@contextlib.contextmanager
def capturing(stream, body_graph):
    """Capture the torch work of the block, on ``stream``, into a
    conditional node's body graph."""
    from windflow_tpu_torch.kernels import build
    _call(build.entry(NAME, "wf_capture_to"), stream.cuda_stream,
          body_graph)
    ok = False
    try:
        with torch.cuda.stream(stream):
            yield
        ok = True
    finally:
        rc = build.entry(NAME, "wf_cond_close")(stream.cuda_stream)
        if ok and rc != 0:
            raise WindFlowError(
                f"{NAME}: CUDA error {rc} closing a conditional body")


def body_streams(device) -> tuple:
    """The side streams :func:`prepare` made for ``device``."""
    streams = _streams.get(_device(device))
    if streams is None:
        raise WindFlowError("wavefront loop: prepare(device) must run "
                            "before the first capture")
    return streams


def emit_loop(cnt: torch.Tensor, cur: torch.Tensor, widths: List[int],
              class_body: Callable[[int], None]) -> None:
    """Capture the loop into the graph the current stream is capturing
    (through ``ffat_cuda.CountedGraph.capture``): the reset launch, then
    a WHILE node whose body is ``wavefront_advance`` and a SWITCH node of
    the width classes, body j ``class_body(widths[j])``: torch work on
    the current stream, reading rank r's slice from ``cur[2]``/``cur[3]``."""
    graph = fc.current_capture()
    if graph is None or not torch.cuda.is_current_stream_capturing():
        raise WindFlowError("wavefront loop: emit_loop runs inside a "
                            "CountedGraph capture only")
    dev = cnt.device
    _check_args(cnt, cur)
    s_body, s_cls = body_streams(dev)
    parent = torch.cuda.current_stream(dev)
    loop_h = new_handle(parent)
    wavefront_advance(cnt, cur, widths, True, loop_handle=loop_h)
    with loop_pool(graph, dev).routing():
        (while_body,) = add_node(parent, loop_h, _WHILE, 1)
        with capturing(s_body, while_body):
            cls_h = new_handle(s_body)
            wavefront_advance(cnt, cur, widths, False, cls_handle=cls_h,
                              loop_handle=loop_h, count=False,
                              stream=s_body)
            bodies = add_node(s_body, cls_h, _SWITCH, len(widths))
            for width, body_graph in zip(widths, bodies):
                with capturing(s_cls, body_graph):
                    class_body(width)


def run_loop_plain(cnt: torch.Tensor, cur: torch.Tensor, widths: List[int],
                   class_body: Callable[[int], None]) -> int:
    """The loop's contract on the host (CPU tensors): reset, then one
    pass a live rank — :func:`advance_plain` and the picked class's
    body.  Returns the passes."""
    advance_plain(cnt, cur, widths, True)
    passes = 0
    while int(cur[4]):
        advance_plain(cnt, cur, widths, False)
        class_body(widths[int(cur[5])])
        passes += 1
    return passes
