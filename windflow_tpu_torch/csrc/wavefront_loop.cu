// The stateful wavefront as a device loop: a conditional WHILE node of a
// CUDA graph and the one-thread kernel that steers it.
//
// Replaces: no Pallas kernel.  It is the counterpart of the
// jax.lax.while_loop of windflow_tpu/ops/tpu_stateful.py _wavefront_body
// (the rank-wavefront stateful apply), whose depth -- the hottest key's
// lane count in the batch -- XLA reads on the device.  Eager PyTorch has
// no device loop, so the port read the per-rank lane counts on the host
// every step; a WHILE node (CUDA 12.4+) gives the loop back to the card,
// and a megastep capture can then hold the whole stateful step.
//
// Host side (capture only, no kernel): a conditional node added to the
// graph the parent stream is capturing, after the capture's current
// dependencies, which then become the node alone; its body graphs are
// captured on a second stream with cudaStreamBeginCaptureToGraph.  The
// same entry points make the node of the width classes inside the WHILE
// body: one SWITCH node (CUDA 12.8) whose body j is class j
// (windflow_tpu_torch/kernels/loop_cuda.py routes the bodies' torch
// allocations to a pool that lives as long as the graph).  One SWITCH
// node is one conditional evaluation a pass, where a chain of IF nodes
// would be one a class.
//
// Device side: wavefront_advance, one thread.  Cursor layout (int64 x 6):
//   cur[0] r      the next rank          cur[3] count  rank r's lanes
//   cur[1] off    lanes before rank r    cur[4] more   rank r + 1 is live
//   cur[2] base   rank r's first lane    cur[5] cls    the width class
// reset = 1 (the launch before the node) zeroes the cursor and sets the
// loop's handle from cnt[0] > 0.  reset = 0 (first node of the body)
// publishes rank r's slice (base, count), picks the smallest width class
// w >= count and sets the SWITCH handle to it, advances r and off, and
// sets the loop's handle from cnt[r + 1] > 0: the body runs once a live
// rank, depth times in all.  The per-rank
// counts are non-increasing in r (a key with lanes at rank r has lanes at
// every smaller rank), so the first zero ends the loop.
//
// What bounds it on an H100: latency.  One thread reads two ints and
// writes six words; the pass costs a kernel node and the conditional
// evaluations (~microseconds), against the bytes of a class body's gather
// and scatter.  The design therefore keeps the kernel to one launch a
// pass and sets the class handles itself (no predicate kernel a class).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CLASSES = 16;

struct LoopArgs {
  int ncls;                          // width classes, descending
  int width[MAX_CLASSES];
  unsigned long long cls_handle;     // the SWITCH handle
  unsigned long long loop_handle;    // the WHILE handle
  int set_handles;                   // 0 outside a graph
  int reset;
};

__global__ void wavefront_advance(const int32_t* __restrict__ cnt,
                                  long long cap, long long* cur,
                                  unsigned long long* passes, LoopArgs a) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  if (a.reset) {
    const int c0 = cap > 0 ? cnt[0] : 0;
    cur[0] = 0;
    cur[1] = 0;
    cur[2] = 0;
    cur[3] = 0;
    cur[4] = c0 > 0;
    cur[5] = -1;
    if (a.set_handles)
      cudaGraphSetConditional(
          (cudaGraphConditionalHandle)a.loop_handle, c0 > 0 ? 1u : 0u);
    return;
  }
  const long long r = cur[0];
  const long long off = cur[1];
  const int c = r < cap ? cnt[r] : 0;
  int cls = -1;
  if (c > 0) {
    for (int j = a.ncls - 1; j >= 0; --j) {
      if (a.width[j] >= c) {
        cls = j;
        break;
      }
    }
  }
  const int nxt = r + 1 < cap ? cnt[r + 1] : 0;
  cur[0] = r + 1;
  cur[1] = off + c;
  cur[2] = off;
  cur[3] = c;
  cur[4] = nxt > 0;
  cur[5] = cls;
  if (a.set_handles) {
    // the SWITCH node runs its body `cls` (none for -1: a value past the
    // last body)
    cudaGraphSetConditional((cudaGraphConditionalHandle)a.cls_handle,
                            cls < 0 ? (unsigned)a.ncls : (unsigned)cls);
    cudaGraphSetConditional((cudaGraphConditionalHandle)a.loop_handle,
                            nxt > 0 ? 1u : 0u);
  }
  atomicAdd(passes, 1ull);
}

}  // namespace

// One launch of wavefront_advance on `stream`.  `widths` is a host array
// of `ncls` entries; with set_handles (inside a capture) the kernel sets
// the SWITCH handle `cls_handle` (reset sets none) and the loop's handle.
// Returns the launch's cudaError_t.
extern "C" int wf_wavefront_advance(const void* cnt, long long cap, void* cur,
                                    void* passes, const int* widths, int ncls,
                                    unsigned long long cls_handle,
                                    unsigned long long loop_handle,
                                    int set_handles, int reset, void* stream) {
  if (ncls < 1 || ncls > MAX_CLASSES) return (int)cudaErrorInvalidValue;
  LoopArgs a{};
  a.ncls = ncls;
  for (int j = 0; j < ncls; ++j) a.width[j] = widths[j];
  a.cls_handle = cls_handle;
  a.loop_handle = loop_handle;
  a.set_handles = set_handles;
  a.reset = reset;
  wavefront_advance<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), cap, static_cast<long long*>(cur),
      static_cast<unsigned long long*>(passes), a);
  return (int)cudaGetLastError();
}

// A conditional handle of the graph `stream` is capturing into (the
// graph that will hold the node the handle steers).
extern "C" int wf_cond_handle(void* stream, unsigned long long* out) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph,
                                             nullptr, nullptr, nullptr);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph,
                                             nullptr, nullptr);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  *out = (unsigned long long)h;
  return 0;
}

// Add a conditional node of `kind` (0 IF, 1 WHILE, 2 SWITCH) with `size`
// bodies, steered by `handle`, to the graph `parent` captures, after its
// current dependencies; make the node the parent's only dependency; the
// body graphs go to `bodies` (captured with wf_capture_to).
extern "C" int wf_cond_add(void* parent, unsigned long long handle, int kind,
                           int size, void** bodies) {
  cudaStream_t st = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph,
                                             &deps, nullptr, &ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph,
                                             &deps, &ndeps);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphNodeParams p{};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  if (kind == 1) {
    p.conditional.type = cudaGraphCondTypeWhile;
  } else if (kind == 2) {
#if CUDART_VERSION >= 12080
    p.conditional.type = cudaGraphCondTypeSwitch;
#else
    return (int)cudaErrorNotSupported;
#endif
  } else {
    p.conditional.type = cudaGraphCondTypeIf;
  }
  p.conditional.size = (unsigned)size;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &p);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &p);
#endif
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < size; ++j) bodies[j] = p.conditional.phGraph_out[j];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  return (int)err;
}

// Begin capturing `stream` into `graph` (a conditional node's body).
extern "C" int wf_capture_to(void* stream, void* graph) {
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// End the capture of a conditional node's body.
extern "C" int wf_cond_close(void* body) {
  cudaGraph_t graph = nullptr;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// A non-blocking stream for capturing bodies (made outside any capture).
extern "C" int wf_body_stream(void** out) {
  cudaStream_t st;
  cudaError_t err = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  if (err != cudaSuccess) return (int)err;
  *out = st;
  return 0;
}
