// Segmented reduce into dense slot tables for declared monoids.
//
// Replaces: windflow_tpu/kernels/pallas_ffat.py dense_monoid_table (the
// Pallas TPU kernel behind routed_monoid_tables), which the keyed device
// reduce runs for its dense and compacted steps.  For every column of
// every leaf:
//   table[s] = fold(op, init, leaf[lanes with row == s])   s in [0, S)
// Lanes whose row lies outside [0, S) contribute nothing.  A leaf is [B]
// or [B, W <= 8] (row-major, so column c of lane i is leaf[i * W + c]),
// f32, i32, i64 or bool, with its own op (sum, max, min) and init.  Bool
// folds as 0/1: sum and max are OR, min is AND.
//
// What bounds it on an H100: bytes.  Each row and each leaf element is
// read once and each table written once: at the main path's compacted
// max (row int32 [262144], packed int64 carrier [262144, 3], S = 1024)
// about 7.4 MB, ~2.2 us at 3.35 TB/s.  The fold is one compare or add a
// lane and column.
//
// Design.  The TPU kernel walks lane tiles on a sequential grid with the
// tables resident in its output block; CUDA blocks run in no order, so
// the fold is split in two passes, both launched by one call:
//   pass 1: grid (tiles, columns).  A block folds its tile's lanes of one
//     column into a [S] table in shared memory (S <= 4096: at most 32 KB)
//     and writes that partial table out ([columns, tiles, S] words).
//     Integer, bool, max and min columns fold with shared-memory atomics:
//     their result does not depend on the order.  An f32 sum must not
//     depend on arrival order, so there thread t owns the slots with
//     s % 256 == t and every thread walks the tile's lanes in lane order
//     (rows staged in shared memory, 2,048 at a time), adding only the
//     lanes of its own slots: a sequential fold, no atomics.
//   pass 2: one thread per (slot, column) folds init and the partials in
//     tile order.
// So every result is the same from run to run.  max, min and integer
// sums equal the plain version bit for bit (two's-complement wrap as
// torch's integer add; max/min propagate NaN); an f32 sum is a
// reassociation of the plain scatter-add's sequence, exact on
// integer-valued data below 2^24 (the declared-sum tolerance of
// pallas_ffat.py:40-46).  The partial tables cost two more passes over
// tiles * S words per column (3 MB at the main shape); few enough tiles
// keep that below the input's size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;    // pass-1 threads; power of two (slot owner)
constexpr int CHUNK = 2048;     // lanes of rows staged at a time (walk)
constexpr int MAX_COLS = 32;    // columns per call
constexpr int DESC_WORDS = 7;   // host descriptor words per column

enum { DT_F32 = 0, DT_I32 = 1, DT_I64 = 2, DT_BOOL = 3 };
enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

struct Cols {
  const void* in[MAX_COLS];
  void* out[MAX_COLS];
  int width[MAX_COLS];     // W of the leaf (1 for a [B] leaf)
  int col[MAX_COLS];       // column within the leaf
  int dt[MAX_COLS];
  int op[MAX_COLS];
  long long init[MAX_COLS];  // the init's bits (f32: its 32-bit pattern)
};

__device__ __forceinline__ float fmax_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// a is the older operand (init or an earlier tile), b the newer
template <typename T, int OP>
__device__ __forceinline__ T comb(T a, T b);
template <> __device__ __forceinline__ float comb<float, OP_SUM>(float a, float b) {
  return a + b;
}
template <> __device__ __forceinline__ float comb<float, OP_MAX>(float a, float b) {
  return fmax_nan(a, b);
}
template <> __device__ __forceinline__ float comb<float, OP_MIN>(float a, float b) {
  return fmin_nan(a, b);
}
template <> __device__ __forceinline__ int comb<int, OP_SUM>(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
template <> __device__ __forceinline__ int comb<int, OP_MAX>(int a, int b) {
  return a > b ? a : b;
}
template <> __device__ __forceinline__ int comb<int, OP_MIN>(int a, int b) {
  return a < b ? a : b;
}
template <>
__device__ __forceinline__ long long comb<long long, OP_SUM>(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
template <>
__device__ __forceinline__ long long comb<long long, OP_MAX>(long long a, long long b) {
  return a > b ? a : b;
}
template <>
__device__ __forceinline__ long long comb<long long, OP_MIN>(long long a, long long b) {
  return a < b ? a : b;
}

template <typename T, int OP> __device__ __forceinline__ T identity();
template <> __device__ __forceinline__ float identity<float, OP_SUM>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, OP_MAX>() { return -INFINITY; }
template <> __device__ __forceinline__ float identity<float, OP_MIN>() { return INFINITY; }
template <> __device__ __forceinline__ int identity<int, OP_SUM>() { return 0; }
template <> __device__ __forceinline__ int identity<int, OP_MAX>() { return INT32_MIN; }
template <> __device__ __forceinline__ int identity<int, OP_MIN>() { return INT32_MAX; }
template <> __device__ __forceinline__ long long identity<long long, OP_SUM>() { return 0; }
template <> __device__ __forceinline__ long long identity<long long, OP_MAX>() {
  return (long long)INT64_MIN;
}
template <> __device__ __forceinline__ long long identity<long long, OP_MIN>() {
  return (long long)INT64_MAX;
}

// shared-memory fold of one lane into its slot (order-independent ops)
template <typename T, int OP>
__device__ __forceinline__ void atomic_fold(T* p, T v);
template <> __device__ __forceinline__ void atomic_fold<float, OP_MAX>(float* p, float v) {
  int* ip = reinterpret_cast<int*>(p);
  int old = *ip, assumed;
  do {
    assumed = old;
    const int nv = __float_as_int(fmax_nan(__int_as_float(assumed), v));
    if (nv == assumed) break;
    old = atomicCAS(ip, assumed, nv);
  } while (old != assumed);
}
template <> __device__ __forceinline__ void atomic_fold<float, OP_MIN>(float* p, float v) {
  int* ip = reinterpret_cast<int*>(p);
  int old = *ip, assumed;
  do {
    assumed = old;
    const int nv = __float_as_int(fmin_nan(__int_as_float(assumed), v));
    if (nv == assumed) break;
    old = atomicCAS(ip, assumed, nv);
  } while (old != assumed);
}
template <> __device__ __forceinline__ void atomic_fold<int, OP_SUM>(int* p, int v) {
  atomicAdd(p, v);
}
template <> __device__ __forceinline__ void atomic_fold<int, OP_MAX>(int* p, int v) {
  atomicMax(p, v);
}
template <> __device__ __forceinline__ void atomic_fold<int, OP_MIN>(int* p, int v) {
  atomicMin(p, v);
}
template <>
__device__ __forceinline__ void atomic_fold<long long, OP_SUM>(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}
template <>
__device__ __forceinline__ void atomic_fold<long long, OP_MAX>(long long* p, long long v) {
  atomicMax(p, v);
}
template <>
__device__ __forceinline__ void atomic_fold<long long, OP_MIN>(long long* p, long long v) {
  atomicMin(p, v);
}

template <typename T, int DT>
__device__ __forceinline__ T load(const void* in, size_t i) {
  if constexpr (DT == DT_BOOL) {
    return static_cast<const uint8_t*>(in)[i] ? 1 : 0;
  } else {
    return static_cast<const T*>(in)[i];
  }
}

template <typename T, int DT>
__device__ __forceinline__ void store(void* out, size_t i, T v) {
  if constexpr (DT == DT_BOOL) {
    static_cast<uint8_t*>(out)[i] = v != 0;
  } else {
    static_cast<T*>(out)[i] = v;
  }
}

template <typename T, int DT>
__device__ __forceinline__ T from_bits(long long bits) {
  if constexpr (DT == DT_F32) {
    return __int_as_float((int)(bits & 0xffffffffLL));
  } else if constexpr (DT == DT_BOOL) {
    return bits != 0;
  } else {
    return (T)bits;
  }
}

// One block: the partial table of lanes [lo, hi) for one column.
template <typename T, int OP, int DT>
__device__ void pass1_col(const int32_t* __restrict__ row, int lo, int hi,
                          int S, const void* in, int W, int col,
                          unsigned long long* part, unsigned char* smem) {
  T* tab = reinterpret_cast<T*>(smem);
  const T id = identity<T, OP>();
  for (int s = threadIdx.x; s < S; s += THREADS) tab[s] = id;
  __syncthreads();
  if constexpr (DT == DT_F32 && OP == OP_SUM) {
    // ordered walk: thread t owns slots s % THREADS == t
    int32_t* srow = reinterpret_cast<int32_t*>(smem + (size_t)S * 8);
    for (int base = lo; base < hi; base += CHUNK) {
      const int n = min(CHUNK, hi - base);
      for (int i = threadIdx.x; i < n; i += THREADS) srow[i] = row[base + i];
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const int r = srow[i];
        if ((unsigned)r < (unsigned)S && (r & (THREADS - 1)) == (int)threadIdx.x)
          tab[r] = tab[r] + load<T, DT>(in, (size_t)(base + i) * W + col);
      }
      __syncthreads();
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
      const int r = row[i];
      if ((unsigned)r < (unsigned)S)
        atomic_fold<T, OP>(&tab[r], load<T, DT>(in, (size_t)i * W + col));
    }
    __syncthreads();
  }
  for (int s = threadIdx.x; s < S; s += THREADS)
    *reinterpret_cast<T*>(&part[s]) = tab[s];
}

// One thread: slot s of one column, init then the partials in tile order.
template <typename T, int OP, int DT>
__device__ void pass2_col(int s, int S, int NT,
                          const unsigned long long* __restrict__ part,
                          long long init, void* out, int W, int col) {
  T acc = from_bits<T, DT>(init);
  for (int t = 0; t < NT; ++t)
    acc = comb<T, OP>(acc, *reinterpret_cast<const T*>(&part[(size_t)t * S + s]));
  store<T, DT>(out, (size_t)s * W + col, acc);
}

// bool folds as int 0/1: sum (OR) takes max
#define WF_DISPATCH(FN, ...)                                                 \
  switch (cs.dt[c] * 3 + cs.op[c]) {                                        \
    case DT_F32 * 3 + OP_SUM: FN<float, OP_SUM, DT_F32>(__VA_ARGS__); break; \
    case DT_F32 * 3 + OP_MAX: FN<float, OP_MAX, DT_F32>(__VA_ARGS__); break; \
    case DT_F32 * 3 + OP_MIN: FN<float, OP_MIN, DT_F32>(__VA_ARGS__); break; \
    case DT_I32 * 3 + OP_SUM: FN<int, OP_SUM, DT_I32>(__VA_ARGS__); break;   \
    case DT_I32 * 3 + OP_MAX: FN<int, OP_MAX, DT_I32>(__VA_ARGS__); break;   \
    case DT_I32 * 3 + OP_MIN: FN<int, OP_MIN, DT_I32>(__VA_ARGS__); break;   \
    case DT_I64 * 3 + OP_SUM: FN<long long, OP_SUM, DT_I64>(__VA_ARGS__); break; \
    case DT_I64 * 3 + OP_MAX: FN<long long, OP_MAX, DT_I64>(__VA_ARGS__); break; \
    case DT_I64 * 3 + OP_MIN: FN<long long, OP_MIN, DT_I64>(__VA_ARGS__); break; \
    case DT_BOOL * 3 + OP_SUM:                                              \
    case DT_BOOL * 3 + OP_MAX: FN<int, OP_MAX, DT_BOOL>(__VA_ARGS__); break; \
    case DT_BOOL * 3 + OP_MIN: FN<int, OP_MIN, DT_BOOL>(__VA_ARGS__); break; \
    default: break;                                                         \
  }

__global__ void __launch_bounds__(THREADS)
table_pass1(const int32_t* __restrict__ row, int B, int S, int L, int NT,
            Cols cs, unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int t = blockIdx.x, c = blockIdx.y;
  const int lo = t * L;
  const int hi = min(B, lo + L);
  unsigned long long* part = partial + ((size_t)c * NT + t) * S;
  WF_DISPATCH(pass1_col, row, lo, hi, S, cs.in[c], cs.width[c], cs.col[c],
              part, smem)
}

__global__ void table_pass2(int S, int NT, Cols cs,
                            const unsigned long long* __restrict__ partial) {
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const unsigned long long* part = partial + (size_t)c * NT * S;
  WF_DISPATCH(pass2_col, s, S, NT, part, cs.init[c], cs.out[c], cs.width[c],
              cs.col[c])
}

}  // namespace

// row: int32 [B]; desc: host array of DESC_WORDS int64 per column
// (in pointer, out pointer, W, column, dtype, op, init bits); partial:
// device scratch of ncols * NT * S int64 words; 1 <= NT tiles of
// ceil(B / NT) lanes.  Launches both passes on `stream`; returns the
// CUDA error, else 0.
extern "C" int wf_dense_monoid_table(const void* row, int B, int S, int ncols,
                                     const long long* desc, void* partial,
                                     int NT, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ncols < 1 || ncols > MAX_COLS || S < 1 || S > 4096 || B < 1 || NT < 1)
    return (int)cudaErrorInvalidValue;
  Cols cs;
  for (int c = 0; c < ncols; ++c) {
    const long long* d = desc + (size_t)c * DESC_WORDS;
    cs.in[c] = reinterpret_cast<const void*>(d[0]);
    cs.out[c] = reinterpret_cast<void*>(d[1]);
    cs.width[c] = (int)d[2];
    cs.col[c] = (int)d[3];
    cs.dt[c] = (int)d[4];
    cs.op[c] = (int)d[5];
    cs.init[c] = d[6];
    if (cs.dt[c] < 0 || cs.dt[c] > 3 || cs.op[c] < 0 || cs.op[c] > 2 ||
        cs.width[c] < 1 || cs.col[c] < 0 || cs.col[c] >= cs.width[c])
      return (int)cudaErrorInvalidValue;
  }
  const int L = (B + NT - 1) / NT;
  const size_t smem = (size_t)S * 8 + (size_t)CHUNK * 4;
  table_pass1<<<dim3(NT, ncols), THREADS, smem, st>>>(
      static_cast<const int32_t*>(row), B, S, L, NT, cs,
      static_cast<unsigned long long*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  table_pass2<<<dim3((S + 255) / 256, ncols), 256, 0, st>>>(
      S, NT, cs, static_cast<const unsigned long long*>(partial));
  return (int)cudaGetLastError();
}
