// Pane combine / sliding fold for a declared monoid (sum, max, min).
//
// Replaces: windflow_tpu/kernels/pallas_ffat.py sliding_fold (with
// _fold_leaf), the Pallas TPU kernel behind the declared-monoid FFAT
// fold.  For a [K, NPP] leaf and a bool mask of the same shape:
//   out[k, i] = fold(op, values[k, i-R+1 .. i])
// with invalid panes, and panes left of column 0, as the monoid identity.
//
// What bounds it on an H100: bytes.  Each pane is read once (4 bytes plus
// a 1-byte valid flag) and each output written once (4 bytes): ~19 MB at
// the main path's [1024, 2057] f32 leaf, ~6 us at 3.35 TB/s.  The
// arithmetic is log2(R) + popcount(R) combines a pane, far below the
// card's rate.
//
// Design.  One thread per output (k, i).  A block takes one key row and
// 256 output columns; it stages those columns plus R-1 halo columns in
// shared memory (identity where invalid or left of column 0), then builds
// the power-of-two window folds level by level in shared memory, and each
// thread stitches its output from the newest end — EXACTLY the combine
// tree of ffat_kernels._sliding_reduce_plain (pow2 doubling, then binary
// stitching), so results are bit-identical to the plain torch version
// and to JAX's lax fold, float sums included.  No matrix product: the
// Pallas kernel's banded MXU matmul reassociates float sums, and a TF32
// product would round them.  max/min propagate NaN as torch.maximum and
// torch.minimum do on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COLS = 256;  // output columns per block (one thread each)

enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

template <typename T, int OP> __device__ __forceinline__ T identity();
template <> __device__ __forceinline__ float identity<float, OP_SUM>() {
  return 0.0f;
}
template <> __device__ __forceinline__ float identity<float, OP_MAX>() {
  return -INFINITY;
}
template <> __device__ __forceinline__ float identity<float, OP_MIN>() {
  return INFINITY;
}
template <> __device__ __forceinline__ int32_t identity<int32_t, OP_SUM>() {
  return 0;
}
template <> __device__ __forceinline__ int32_t identity<int32_t, OP_MAX>() {
  return INT32_MIN;
}
template <> __device__ __forceinline__ int32_t identity<int32_t, OP_MIN>() {
  return INT32_MAX;
}

// a is the older operand, b the newer (the order of the plain fold)
template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b);
template <> __device__ __forceinline__ float combine<float, OP_SUM>(float a,
                                                                  float b) {
  return a + b;
}
template <> __device__ __forceinline__ float combine<float, OP_MAX>(float a,
                                                                  float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
template <> __device__ __forceinline__ float combine<float, OP_MIN>(float a,
                                                                  float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, OP_SUM>(int32_t a,
                                                            int32_t b) {
  // two's-complement wrap, as torch's int32 add
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, OP_MAX>(int32_t a,
                                                            int32_t b) {
  return a > b ? a : b;
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, OP_MIN>(int32_t a,
                                                            int32_t b) {
  return a < b ? a : b;
}

// L levels of W slots each in shared memory; level j at slot s holds the
// fold of the 2^j leaves ending at slot s.  Slot 0 is global column
// c0 - (R - 1).
template <typename T, int OP>
__global__ void sliding_fold_kernel(const T* __restrict__ x,
                                    const uint8_t* __restrict__ valid,
                                    T* __restrict__ out, int NPP, int R,
                                    int L) {
  extern __shared__ unsigned char smem_raw[];
  T* lev = reinterpret_cast<T*>(smem_raw);
  const int W = COLS + R - 1;
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int base = c0 - (R - 1);
  const size_t row = (size_t)k * NPP;
  const T id = identity<T, OP>();
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int c = base + s;
    T v = id;
    if (c >= 0 && c < NPP && valid[row + c]) v = x[row + c];
    lev[s] = v;
  }
  __syncthreads();
  for (int j = 1, w = 1; j < L; ++j, w <<= 1) {
    const T* prev = lev + (size_t)(j - 1) * W;
    T* cur = lev + (size_t)j * W;
    // slots s < w are never read by an output of this block
    for (int s = threadIdx.x; s < W; s += blockDim.x)
      cur[s] = s >= w ? combine<T, OP>(prev[s - w], prev[s]) : id;
    __syncthreads();
  }
  const int c = c0 + threadIdx.x;
  if (c >= NPP) return;
  const int s = threadIdx.x + R - 1;
  T res = id;
  bool have = false;
  int offset = 0;
  for (int j = L - 1; j >= 0; --j) {
    const int w = 1 << j;
    if (R & w) {
      const T v = lev[(size_t)j * W + (s - offset)];
      res = have ? combine<T, OP>(v, res) : v;
      have = true;
      offset += w;
    }
  }
  out[row + c] = res;
}

template <typename T, int OP>
int launch(const void* x, const void* valid, void* out, int K, int NPP,
           int R, cudaStream_t st) {
  int L = 1;
  while ((1 << L) <= R) ++L;  // levels 0..L-1 with 2^(L-1) <= R
  const size_t smem = (size_t)L * (COLS + R - 1) * sizeof(T);
  const dim3 grid(K, (NPP + COLS - 1) / COLS);
  sliding_fold_kernel<T, OP><<<grid, COLS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), NPP, R, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [K, NPP] row-major float32 (is_int 0) or int32 (is_int 1);
// valid: [K, NPP] bool (one byte each); op: 0 sum, 1 max, 2 min;
// 1 <= R <= 512.  Launches on `stream`; returns the CUDA error, else 0.
extern "C" int wf_sliding_fold(const void* x, const void* valid, void* out,
                               int K, int NPP, int R, int op, int is_int,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || NPP <= 0) return 0;
  if (R < 1 || R > 512 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  if (is_int) {
    if (op == OP_SUM) return launch<int32_t, OP_SUM>(x, valid, out, K, NPP, R, st);
    if (op == OP_MAX) return launch<int32_t, OP_MAX>(x, valid, out, K, NPP, R, st);
    return launch<int32_t, OP_MIN>(x, valid, out, K, NPP, R, st);
  }
  if (op == OP_SUM) return launch<float, OP_SUM>(x, valid, out, K, NPP, R, st);
  if (op == OP_MAX) return launch<float, OP_MAX>(x, valid, out, K, NPP, R, st);
  return launch<float, OP_MIN>(x, valid, out, K, NPP, R, st);
}
