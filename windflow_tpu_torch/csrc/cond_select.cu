// The steering kernel of a CUDA graph SWITCH node: the port's lax.cond.
//
// Replaces: no Pallas kernel.  It is the counterpart of the JAX package's
// two device-side jax.lax.cond calls: the TB window step's fold, taken
// only when a fire pass fires (windflow_tpu/windows/ffat_kernels.py:733,
// do_fold / no_fold), and the compacted reduce's overflow branches
// (windflow_tpu/parallel/compaction.py:465-467, no_miss / ovf_small /
// ovf_big).  XLA picks a lax.cond branch on the device; eager PyTorch
// would read the predicate on the host.  Here the branch index stays a
// device scalar: a graph holds one SWITCH node whose body j is branch j,
// and this kernel, launched just before the node, sets the node's handle
// from the index.  The node, its handle and its body graphs are made by
// the conditional-node entry points of wavefront_loop.cu
// (windflow_tpu_torch/kernels/cond_cuda.py emits them).
//
// Device side: cond_select, one thread.  It reads the index (int32 or
// int64), picks body `index` when 0 <= index < nbodies and "no body"
// (the value nbodies, past the node's last body) otherwise, sets the
// SWITCH handle to the pick inside a graph, and adds one to counts[pick]
// (counts holds nbodies + 1 int64 words: one a body and one for "none"),
// so a run can show which bodies the card took.
//
// What bounds it on an H100: latency.  One thread reads one word and
// writes one counter; the launch and the node's conditional evaluation
// (~microseconds) are the cost, against the branch's own work (a sliding
// fold of the TB ring, or a sort of the overflow lanes) that it lets the
// card skip.  The design therefore keeps it to one launch a node, with
// no predicate kernel of its own: the caller's index is any device
// scalar, and the kernel clamps it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cond_select(const void* __restrict__ index, int index64,
                            int nbodies, unsigned long long handle,
                            int set_handle, unsigned long long* counts) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const long long i = index64 ? *static_cast<const long long*>(index)
                              : (long long)*static_cast<const int32_t*>(index);
  const int pick = (i >= 0 && i < nbodies) ? (int)i : nbodies;
  if (set_handle)
    cudaGraphSetConditional((cudaGraphConditionalHandle)handle,
                            (unsigned)pick);
  if (counts != nullptr) atomicAdd(counts + pick, 1ull);
}

}  // namespace

// One launch of cond_select on `stream`.  With set_handle (inside a
// capture) the kernel sets the SWITCH handle `handle`; `counts` (nbodies
// + 1 int64 words, or null) counts the pick.  Returns the launch's
// cudaError_t.
extern "C" int wf_cond_select(const void* index, int index64, int nbodies,
                              unsigned long long handle, int set_handle,
                              void* counts, void* stream) {
  if (nbodies < 1) return (int)cudaErrorInvalidValue;
  cond_select<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      index, index64, nbodies, handle, set_handle,
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}
