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
// What bounds it on an H100: latency, not bandwidth.  Each row and each
// leaf element is read once and each table written once: at the main
// path's compacted max (row int32 [262144], packed int64 carrier
// [262144, 3], S = 1024) about 7.4 MB, ~2.2 us at 3.35 TB/s; the fold is
// one compare or add a lane and column.  That is so little that the call
// is two launches, a few DRAM round trips and the shared-memory atomics.
// sm_90 has native 32-bit shared atomic add/max/min, but a 64-bit one
// (the int64 carrier and ts columns) compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64 in the SASS; chip_profile.py lists the opcodes).
// The design keeps every load of a batch in flight at once, reads every
// byte once, and runs one wave of blocks.
//
// Design.  The TPU kernel walks lane tiles on a sequential grid with the
// tables resident in its output block; CUDA blocks run in no order, so
// the fold is two kernels, both launched by one call:
//   pass 1: grid = lane tiles only (the wrapper picks 2,048 lanes a tile:
//     128 blocks at the main shapes, one wave on 132 SMs; 4,096-lane
//     tiles would halve the partials but leave half the SMs idle, and
//     chip_profile.py times both).  A block folds its tile into shared-memory tables for
//     every column, in walks of up to PASS_COLS columns whose tables fit
//     the shared-memory budget: one walk reads the tile's rows once and
//     every column's values of a batch of U 32-lane steps before it folds
//     any, so the loads of all columns are in flight together, and a
//     [B, W] leaf's columns come from the same cache lines.  Each warp
//     walks its own contiguous run of the tile.  Integer, bool, max and
//     min columns fold with shared-memory atomics (64-bit for the int64
//     carrier; an f32 max/min as int atomics on an order-preserving image
//     of the float, not a CAS loop): their result does not depend on the
//     order.  An f32 sum must not depend on arrival order, so there each
//     warp has a private table: for each 32-lane step, __match_any_sync
//     groups the lanes of one slot, the group's lowest lane sums the
//     group's values in ascending lane order (one shuffle per lane of a
//     group that has more than one), and adds the total into its warp's
//     table, which no other warp writes.  The warp tables are then folded
//     in warp order.  Above 48 KB the tables use the opt-in dynamic
//     shared memory (up to SMEM_BUDGET); at S = 4096 eight warps walk and
//     own an f32 table (128 KB).  The tile's tables go out as partials in
//     their own width (4 or 8 bytes).
//   pass 2: per (32 slots, column) a block of P2_GROUPS warps; warp g
//     folds the partials of its contiguous run of tiles in tile order, and
//     the runs then fold in order after init: a fixed tree, many threads
//     a slot, no dependent chain over all tiles.
// So every result is the same from run to run, and no global atomics are
// used at all.  max, min and integer sums equal the plain version bit
// for bit (two's-complement wrap as torch's integer add; max/min
// propagate NaN, as the canonical quiet NaN); an f32 sum is a
// reassociation of the plain scatter-add's sequence, exact on
// integer-valued data below 2^24 (the declared-sum tolerance of
// pallas_ffat.py:40-46).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;            // pass-1 threads
constexpr int NWARPS = THREADS / 32;
constexpr int U = 4;                    // 32-lane steps a warp loads at once
constexpr int PASS_COLS = 4;            // columns one walk folds together
constexpr int P2_GROUPS = 16;           // pass-2 tile runs (warps) per slot
constexpr int MAX_COLS = 32;            // columns per call
constexpr int DESC_WORDS = 7;           // host descriptor words per column
constexpr int SMEM_BUDGET = 128 * 1024; // pass-1 dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

enum { DT_F32 = 0, DT_I32 = 1, DT_I64 = 2, DT_BOOL = 3 };
enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

struct Cols {
  const void* in[MAX_COLS];
  void* out[MAX_COLS];
  long long part[MAX_COLS];  // byte offset of the column's partials
  long long init[MAX_COLS];  // the init's bits (f32: its 32-bit pattern)
  int width[MAX_COLS];       // W of the leaf (1 for a [B] leaf)
  int col[MAX_COLS];         // column within the leaf
  int dt[MAX_COLS];
  int op[MAX_COLS];
  int tab_off[MAX_COLS];     // byte offset of the column's table(s) in smem
};

// a walk: columns first .. first + ncol - 1
struct Walks {
  int n;
  int first[MAX_COLS];
  int ncol[MAX_COLS];
  int nwt[MAX_COLS];         // warps that walk (each owns an f32-sum table)
  int fsum[MAX_COLS];        // the walk has an f32-sum column
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

// An f32 max/min column folds as int atomics on an order-preserving
// image of the float (negative floats flip their magnitude bits); a NaN
// maps past every number (above for max, below for min) and comes back
// as the canonical quiet NaN, so it wins as in fmax_nan/fmin_nan.
template <int OP>
__device__ __forceinline__ int f32_key(float f) {
  if (f != f) return OP == OP_MAX ? INT32_MAX : INT32_MIN;
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
template <int OP>
__device__ __forceinline__ float f32_of_key(int k) {
  if (k == (OP == OP_MAX ? INT32_MAX : INT32_MIN)) return __int_as_float(0x7fc00000);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
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

// the row of lane i as a slot, or -1 (outside [0, S) or past the run)
__device__ __forceinline__ int slot_of(const int32_t* __restrict__ row, int i,
                                       int hi, int S) {
  const int r = i < hi ? __ldg(row + i) : -1;
  return (unsigned)r < (unsigned)S ? r : -1;
}

// element i of a leaf as raw bits (f32 as its pattern, bool as 0/1)
__device__ __forceinline__ unsigned long long load_raw(const void* in, int dt,
                                                       size_t i) {
  if (dt == DT_I64) return (unsigned long long)__ldg(static_cast<const long long*>(in) + i);
  if (dt == DT_BOOL) return __ldg(static_cast<const unsigned char*>(in) + i) ? 1 : 0;
  return (unsigned)__ldg(static_cast<const int*>(in) + i);
}

template <typename T>
__device__ __forceinline__ T from_raw(unsigned long long v) {
  if constexpr (sizeof(T) == 8) {
    return (T)v;
  } else if constexpr (std::is_same<T, float>::value) {
    return __int_as_float((int)(unsigned)v);
  } else {
    return (T)(int)(unsigned)v;
  }
}

// Fill a column's table(s) (n elements) with the identity.
template <typename T, int OP, int DT>
__device__ __forceinline__ void init_table(unsigned char* tab_bytes, int n) {
  if constexpr (DT == DT_F32 && OP != OP_SUM) {
    int* tab = reinterpret_cast<int*>(tab_bytes);
    const int id = f32_key<OP>(identity<float, OP>());
    for (int j = threadIdx.x; j < n; j += THREADS) tab[j] = id;
  } else {
    T* tab = reinterpret_cast<T*>(tab_bytes);
    const T id = identity<T, OP>();
    for (int j = threadIdx.x; j < n; j += THREADS) tab[j] = id;
  }
}

// Fold one column's values of a warp's U steps into its table.  An f32
// sum goes to the warp's own table in ascending lane order; every other
// op to the block's table with shared-memory atomics.
template <typename T, int OP, int DT>
__device__ __forceinline__ void fold_steps(unsigned char* tab_bytes, int S,
                                           const unsigned long long (&raw)[U],
                                           const int (&key)[U],
                                           const unsigned (&peers)[U],
                                           const unsigned (&multi)[U]) {
  T* tab = reinterpret_cast<T*>(tab_bytes);
  if constexpr (DT == DT_F32 && OP == OP_SUM) {
    const int lane = threadIdx.x & 31;
    T* mine = tab + (size_t)(threadIdx.x >> 5) * S;
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float v = from_raw<float>(raw[u]);
      // the group's lowest lane adds its peers in ascending lane order
      const bool lead = (peers[u] & below) == 0;
      float acc = v;
      for (unsigned rest = multi[u]; rest; rest &= rest - 1) {
        const int k = __ffs(rest) - 1;
        const float x = __shfl_sync(FULL, v, k);
        if (lead && k != lane && ((peers[u] >> k) & 1)) acc += x;
      }
      if (lead && key[u] >= 0) mine[key[u]] += acc;
      __syncwarp();
    }
  } else if constexpr (DT == DT_F32) {
    int* itab = reinterpret_cast<int*>(tab_bytes);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (key[u] >= 0) atomic_fold<int, OP>(&itab[key[u]], f32_key<OP>(from_raw<float>(raw[u])));
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (key[u] >= 0) atomic_fold<T, OP>(&tab[key[u]], from_raw<T>(raw[u]));
  }
}

// Write a column's table out as tile t's partial; an f32 sum folds its
// nwt warp tables in warp order.
template <typename T, int OP, int DT>
__device__ __forceinline__ void flush_table(const unsigned char* tab_bytes,
                                            int S, int nwt,
                                            unsigned char* part_bytes, int t) {
  const T* tab = reinterpret_cast<const T*>(tab_bytes);
  T* part = reinterpret_cast<T*>(part_bytes) + (size_t)t * S;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    if constexpr (DT == DT_F32 && OP != OP_SUM) {
      part[s] = f32_of_key<OP>(reinterpret_cast<const int*>(tab_bytes)[s]);
    } else {
      T acc = tab[s];
      if constexpr (DT == DT_F32)
        for (int w = 1; w < nwt; ++w) acc += tab[(size_t)w * S + s];
      part[s] = acc;
    }
  }
}

// Pass 2, one column: slot s, tile run g of P2_GROUPS, then the runs in
// order after init (by warp 0).
template <typename T, int OP, int DT>
__device__ __forceinline__ void fold_col(int S, int NT, const Cols& cs, int c,
                                         const unsigned char* __restrict__ partial,
                                         unsigned long long (&run)[P2_GROUPS][32]) {
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  const T* p = reinterpret_cast<const T*>(partial + cs.part[c]);
  const int per = (NT + P2_GROUPS - 1) / P2_GROUPS;
  const int t0 = min(NT, g * per), t1 = min(NT, t0 + per);
  if (s < S && t0 < t1) {
    T acc = p[(size_t)t0 * S + s];
#pragma unroll 8
    for (int t = t0 + 1; t < t1; ++t) acc = comb<T, OP>(acc, p[(size_t)t * S + s]);
    *reinterpret_cast<T*>(&run[g][lane]) = acc;
  }
  __syncthreads();
  if (g == 0 && s < S) {
    T acc = from_bits<T, DT>(cs.init[c]);
    for (int k = 0; k < P2_GROUPS && k * per < NT; ++k)
      acc = comb<T, OP>(acc, *reinterpret_cast<const T*>(&run[k][lane]));
    store<T, DT>(cs.out[c], (size_t)s * cs.width[c] + cs.col[c], acc);
  }
}

// bool folds as int 0/1: sum (OR) takes max
#define WF_DISPATCH(DT_, OP_, FN, ...)                                       \
  switch ((DT_) * 3 + (OP_)) {                                              \
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
table_pass1(const int32_t* __restrict__ row, int B, int S, int L, Cols cs,
            Walks ws, unsigned char* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lo = t * L;
  const int hi = min(B, lo + L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = 0; p < ws.n; ++p) {
    const int first = ws.first[p], nc = ws.ncol[p], nwt = ws.nwt[p];
    for (int q = 0; q < nc; ++q) {
      const int c = first + q;
      const bool fsum = cs.dt[c] == DT_F32 && cs.op[c] == OP_SUM;
      WF_DISPATCH(cs.dt[c], cs.op[c], init_table, smem + cs.tab_off[c],
                  fsum ? nwt * S : S)
    }
    __syncthreads();
    if (warp < nwt) {
      // warp w walks its own contiguous run of the tile, U steps a batch
      const int per = (((hi - lo) + nwt - 1) / nwt + 31) & ~31;
      const int a = lo + warp * per;
      const int b = min(hi, a + per);
      for (int base = a; base < b; base += 32 * U) {
        int key[U];
        unsigned peers[U], multi[U];
#pragma unroll
        for (int u = 0; u < U; ++u) key[u] = slot_of(row, base + u * 32 + lane, b, S);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          peers[u] = ws.fsum[p] ? __match_any_sync(FULL, key[u]) : 0u;
          multi[u] = ws.fsum[p] ? __ballot_sync(FULL, peers[u] != (1u << lane)) : 0u;
        }
        // every column's values of the batch in flight with the rows and
        // before any folds (a value's address does not need its row)
        unsigned long long raw[PASS_COLS][U];
#pragma unroll
        for (int q = 0; q < PASS_COLS; ++q) {
          const int c = first + q;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = base + u * 32 + lane;
            raw[q][u] = q < nc && i < b
                ? load_raw(cs.in[c], cs.dt[c], (size_t)i * cs.width[c] + cs.col[c])
                : 0ull;
          }
        }
#pragma unroll
        for (int q = 0; q < PASS_COLS; ++q) {
          if (q < nc) {
            const int c = first + q;
            WF_DISPATCH(cs.dt[c], cs.op[c], fold_steps, smem + cs.tab_off[c],
                        S, raw[q], key, peers, multi)
          }
        }
      }
    }
    __syncthreads();
    for (int q = 0; q < nc; ++q) {
      const int c = first + q;
      WF_DISPATCH(cs.dt[c], cs.op[c], flush_table, smem + cs.tab_off[c], S,
                  nwt, partial + cs.part[c], t)
    }
    __syncthreads();  // the next walk reuses the shared memory
  }
}

__global__ void __launch_bounds__(32 * P2_GROUPS)
table_pass2(int S, int NT, Cols cs, const unsigned char* __restrict__ partial) {
  __shared__ unsigned long long run[P2_GROUPS][32];
  const int c = blockIdx.y;
  WF_DISPATCH(cs.dt[c], cs.op[c], fold_col, S, NT, cs, c, partial, run)
}

int elem_bytes(int dt) { return dt == DT_I64 ? 8 : 4; }

}  // namespace

// row: int32 [B]; desc: host array of DESC_WORDS int64 per column
// (in pointer, out pointer, W, column, dtype, op, init bits); partial:
// device scratch of at least ncols * NT * S * 8 bytes; NT >= 1 tiles of
// ceil(B / NT) lanes.  Launches both passes on `stream`; returns the CUDA
// error, else 0.
extern "C" int wf_dense_monoid_table(const void* row, int B, int S, int ncols,
                                     const long long* desc, void* partial,
                                     int NT, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ncols < 1 || ncols > MAX_COLS || S < 1 || S > 4096 || B < 1 || NT < 1)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      table_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
  if (attr != cudaSuccess) return (int)attr;
  // an f32 sum keeps one table of S floats per walking warp: halve the
  // walking warps until one such column fits the budget
  int nwt_f = NWARPS;
  while (nwt_f > 1 && (size_t)nwt_f * S * 4 > (size_t)SMEM_BUDGET) nwt_f /= 2;
  Cols cs;
  Walks ws;
  ws.n = 0;
  long long off = 0;
  size_t used = 0, smem = 0;
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
    const int eb = elem_bytes(cs.dt[c]);
    off = (off + eb - 1) / eb * eb;
    cs.part[c] = off;
    off += (long long)NT * S * eb;
    const bool fsum = cs.dt[c] == DT_F32 && cs.op[c] == OP_SUM;
    const size_t bytes = fsum ? (size_t)nwt_f * S * 4 : (size_t)S * eb;
    const int p = ws.n - 1;
    used = (used + 7) / 8 * 8;
    if (p < 0 || ws.ncol[p] == PASS_COLS || used + bytes > (size_t)SMEM_BUDGET) {
      ws.first[ws.n] = c;
      ws.ncol[ws.n] = 0;
      ws.nwt[ws.n] = NWARPS;
      ws.fsum[ws.n] = 0;
      ws.n += 1;
      used = 0;
    }
    const int q = ws.n - 1;
    cs.tab_off[c] = (int)used;
    used += bytes;
    ws.ncol[q] += 1;
    if (fsum) {
      ws.fsum[q] = 1;
      ws.nwt[q] = nwt_f;
    }
    if (used > smem) smem = used;
  }
  const int L = (B + NT - 1) / NT;
  table_pass1<<<NT, THREADS, smem, st>>>(static_cast<const int32_t*>(row), B,
                                         S, L, cs, ws,
                                         static_cast<unsigned char*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  table_pass2<<<dim3((S + 31) / 32, ncols), 32 * P2_GROUPS, 0, st>>>(
      S, NT, cs, static_cast<const unsigned char*>(partial));
  return (int)cudaGetLastError();
}
