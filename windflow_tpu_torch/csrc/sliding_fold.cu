// Pane combine / sliding fold for a declared monoid (sum, max, min).
//
// Replaces: windflow_tpu/kernels/pallas_ffat.py sliding_fold (with
// _fold_leaf), the Pallas TPU kernel behind the declared-monoid FFAT
// fold.  For up to four [K, NPP] leaves (float32 or int32, mixed) and one
// bool mask of the same shape, in one launch:
//   out[k, i] = fold(op, values[k, i-R+1 .. i])
// with invalid panes, and panes left of column 0, as the monoid identity.
//
// What bounds it on an H100: bytes.  The mask is read once a call (one
// byte a pane, shared by every leaf), each output is written once (4
// bytes), and a value has to be read only where its 32-byte sector holds
// a valid pane.  At the FFAT step's [1024, 2057] f32 leaf that is ~19 MB
// when 90% of the panes are valid (5.7 us at 3.35 TB/s), and ~10.6 MB on
// the step's own mask, the R-1 carried panes and one to three new ones a
// key (3.2 us).  The arithmetic is log2(R) + popcount(R) combines a pane.
//
// Design, for R <= 16 with every pointer 16-byte aligned (the FFAT
// step's case).  The [K, NPP] arrays are walked flat.  Each thread owns a
// run of C consecutive outputs (C = 8; 4 and 16 are compiled too at R = 8,
// for chip_profile.py to time), and
// the grid holds at most one wave of resident blocks that stride over the
// runs, so no row has a tail block.  A thread reads the mask bytes of its
// run and of the H slots before it (R-1 rounded up to a 4-slot vector) in
// 4- to 16-byte words and keeps one bit a slot.  A warp whose runs see no
// valid pane (one vote) writes the identity and reads no value.  Otherwise
// each thread issues its 16-byte value loads, only of the vectors that
// hold a valid slot, before any combine, builds the power-of-two levels in
// registers and stitches each output from the newest end: EXACTLY the
// combine tree of ffat_kernels._sliding_reduce_plain (pow2 doubling, then
// binary stitching), so results are bit-identical to the plain torch
// version, float sums included.  Slots of an earlier row hold the
// identity, as the plain fold's shifts fill them; a run that crosses a row
// start is folded once per row it touches.  Every leaf reuses the mask
// bits.  The halo comes from L1 (its sectors are the neighbour run's own
// loads) rather than by shuffles from the neighbour lane, which lane 0
// could not do.
//
// R and C are template arguments, so every index is known to the
// compiler and the levels stay in registers; each (R, C) is one more
// kernel to compile (all R <= 32 at three run lengths, 288 kernels, took
// nvcc 194 s on the card's host).  Other R, or a view that is not 16-byte
// aligned: one block per (row, 256 columns) stages the mask once, then
// leaf by leaf the values and the levels in shared memory (the port's
// first design).
//
// No matrix product: the Pallas kernel's banded MXU matmul reassociates
// float sums, and a TF32 product would round them.  max/min propagate NaN
// as torch.maximum and torch.minimum do on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 4;
constexpr int FAST_MAX_R = 16;  // the largest R of the register path
constexpr int RUN = 8;          // outputs a thread of the register path
constexpr int THREADS = 256;    // threads a block, both paths
constexpr int COLS = 256;       // output columns a block, shared-memory path

enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

struct Leaves {
  const void* x[MAX_LEAVES];
  void* out[MAX_LEAVES];
  int n;         // leaves in this launch
  int int_mask;  // bit l set: leaf l is int32, else float32
};

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

template <typename T> __device__ __forceinline__ T from_bits(uint32_t u);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) {
  return __uint_as_float(u);
}
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t u) {
  return (int32_t)u;
}
__device__ __forceinline__ uint32_t to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t to_bits(int32_t v) { return (uint32_t)v; }

__host__ __device__ constexpr int log2_floor(int r) {
  return r <= 1 ? 0 : 1 + log2_floor(r / 2);
}
__host__ __device__ constexpr int low_bit(int x) { return x & -x; }

// bit b set where byte b of w is not zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (uint32_t)((w & 0xffu) != 0) | (uint32_t)((w & 0xff00u) != 0) << 1 |
         (uint32_t)((w & 0xff0000u) != 0) << 2 |
         (uint32_t)((w & 0xff000000u) != 0) << 3;
}

// leaf l's pointer, without indexing the parameter array at run time
// (which would copy it to local memory)
template <typename P>
__device__ __forceinline__ P pick(P const (&a)[MAX_LEAVES], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// the bits of slots s >= s0
__device__ __forceinline__ uint64_t from_slot(long long s0) {
  return s0 <= 0 ? ~0ull : (s0 >= 64 ? 0ull : ~0ull << s0);
}

// one bit a slot for the W mask bytes at p, read in MW-byte words (p is
// MW-aligned and W a multiple of MW)
template <int W, int MW>
__device__ __forceinline__ uint64_t load_mask(const uint8_t* p) {
  uint64_t m = 0;
  if constexpr (MW == 16) {
#pragma unroll
    for (int v = 0; v < W / 16; ++v) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + v);
      m |= (uint64_t)(nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4 |
                      nonzero_bytes(q.z) << 8 | nonzero_bytes(q.w) << 12)
           << (16 * v);
    }
  } else if constexpr (MW == 8) {
#pragma unroll
    for (int v = 0; v < W / 8; ++v) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + v);
      m |= (uint64_t)(nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4) << (8 * v);
    }
  } else {
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const unsigned int q = __ldg(reinterpret_cast<const unsigned int*>(p) + v);
      m |= (uint64_t)nonzero_bytes(q) << (4 * v);
    }
  }
  return m;
}

// C outputs of the identity from position f0 (16-byte stores where the
// whole run lies before N)
template <typename T, int OP, int C>
__device__ __forceinline__ void store_identity(T* __restrict__ out,
                                               long long f0, long long N) {
  const uint32_t b = to_bits(identity<T, OP>());
  if (f0 + C <= N) {
    uint4* o = reinterpret_cast<uint4*>(out + f0);
#pragma unroll
    for (int v = 0; v < C / 4; ++v) o[v] = make_uint4(b, b, b, b);
  } else {
    for (long long p = f0; p < N; ++p) out[p] = identity<T, OP>();
  }
}

// One leaf of one run: the values of the vectors with a set bit in m,
// all loads issued first, then one fold per row the run touches (rows
// k0..k1; none for a thread past the last run).  Slot s is position
// g0 + s; output i is slot H + i.
template <typename T, int OP, int R, int C>
__device__ __forceinline__ void fold_run(const T* __restrict__ x,
                                         T* __restrict__ out, uint64_t m,
                                         bool inside, long long g0,
                                         long long N, long long NPP,
                                         long long k0, long long k1) {
  constexpr int H = (R + 2) / 4 * 4;
  constexpr int W = H + C;
  constexpr int L = log2_floor(R) + 1;
  const T id = identity<T, OP>();
  const long long f0 = g0 + H;
  T raw[W];
  if (inside) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + g0);
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      if ((m >> (4 * v)) & 0xfull) {
        const uint4 q = __ldg(xv + v);
        raw[4 * v] = from_bits<T>(q.x);
        raw[4 * v + 1] = from_bits<T>(q.y);
        raw[4 * v + 2] = from_bits<T>(q.z);
        raw[4 * v + 3] = from_bits<T>(q.w);
      } else {
        raw[4 * v] = raw[4 * v + 1] = raw[4 * v + 2] = raw[4 * v + 3] = id;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < W; ++s) {
      raw[s] = id;
      if ((m >> s) & 1) raw[s] = x[g0 + s];
    }
  }
  for (long long r = k0; r <= k1; ++r) {
    const long long lo = r * NPP;
    const uint64_t mr = m & from_slot(lo - g0);  // earlier rows: identity
    T lev[L][W];
#pragma unroll
    for (int s = 0; s < W; ++s) lev[0][s] = (mr >> s) & 1 ? raw[s] : id;
    // level j at slot s: the fold of the 2^j slots ending at s (slots
    // s < w of a level are never read)
#pragma unroll
    for (int j = 1; j < L; ++j) {
      const int w = 1 << (j - 1);
#pragma unroll
      for (int s = 0; s < W; ++s)
        lev[j][s] = s >= w ? combine<T, OP>(lev[j - 1][s >= w ? s - w : 0],
                                            lev[j - 1][s])
                           : id;
    }
    T res[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      T acc = id;
      bool have = false;
      int off = 0;
#pragma unroll
      for (int j = L - 1; j >= 0; --j) {
        if (R & (1 << j)) {
          const T v = lev[j][H + i - off];
          acc = have ? combine<T, OP>(v, acc) : v;
          have = true;
          off += 1 << j;
        }
      }
      res[i] = acc;
    }
    if (inside && k0 == k1) {
      uint4* o = reinterpret_cast<uint4*>(out + f0);
#pragma unroll
      for (int v = 0; v < C / 4; ++v)
        o[v] = make_uint4(to_bits(res[4 * v]), to_bits(res[4 * v + 1]),
                          to_bits(res[4 * v + 2]), to_bits(res[4 * v + 3]));
    } else {
      const long long hi = lo + NPP < N ? lo + NPP : N;
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (f0 + i >= lo && f0 + i < hi) out[f0 + i] = res[i];
    }
  }
}

template <int OP, int R, int C>
__global__ void __launch_bounds__(THREADS)
    fold_runs_kernel(Leaves lv, const uint8_t* __restrict__ valid,
                     long long N, long long NPP, long long nruns) {
  constexpr int H = (R + 2) / 4 * 4;  // R - 1 rounded up to a vector
  constexpr int W = H + C;
  constexpr int FIRST = H - (R - 1);  // the first slot a window reads
  constexpr int MW = low_bit(C | H) < 16 ? low_bit(C | H) : 16;
  static_assert(C % 4 == 0 && W <= 64, "run and halo must fit 64 slots");
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long w0 = (long long)blockIdx.x * THREADS + (threadIdx.x - lane);
       w0 < nruns; w0 += stride) {
    const long long run = w0 + lane;
    const bool active = run < nruns;
    const long long f0 = run * C;  // the run's first output
    const long long g0 = f0 - H;   // position of slot 0
    const bool inside = active && g0 >= 0 && f0 + C <= N;
    uint64_t m = 0;
    if (inside) {
      m = load_mask<W, MW>(valid + g0);
    } else if (active) {
      for (int s = 0; s < W; ++s)
        if (g0 + s >= 0 && g0 + s < N && valid[g0 + s]) m |= 1ull << s;
    }
    m &= ~0ull << FIRST;
    long long k0 = 0, k1 = -1;  // rows of the run's outputs
    if (active) {
      k0 = f0 / NPP;
      const long long last = (f0 + C < N ? f0 + C : N) - 1;
      k1 = last < (k0 + 1) * NPP ? k0 : last / NPP;
      m &= from_slot(k0 * NPP - g0);
    }
    if (!__any_sync(0xffffffffu, m != 0)) {
      // no valid pane in any window of the warp: identity, no value read
      if (active) {
        for (int l = 0; l < lv.n; ++l) {
          if ((lv.int_mask >> l) & 1)
            store_identity<int32_t, OP, C>(
                static_cast<int32_t*>(pick(lv.out, l)), f0, N);
          else
            store_identity<float, OP, C>(
                static_cast<float*>(pick(lv.out, l)), f0, N);
        }
      }
      continue;
    }
    for (int l = 0; l < lv.n; ++l) {
      if ((lv.int_mask >> l) & 1)
        fold_run<int32_t, OP, R, C>(
            static_cast<const int32_t*>(pick(lv.x, l)),
            static_cast<int32_t*>(pick(lv.out, l)), m, inside, g0, N, NPP,
            k0, k1);
      else
        fold_run<float, OP, R, C>(static_cast<const float*>(pick(lv.x, l)),
                                  static_cast<float*>(pick(lv.out, l)), m,
                                  inside, g0, N, NPP, k0, k1);
    }
  }
}

// shared-memory path, one leaf: L levels of W slots; level j at slot s
// holds the fold of the 2^j leaves ending at s; slot 0 is column c0-(R-1)
template <typename T, int OP>
__device__ __forceinline__ void smem_fold(const T* __restrict__ x,
                                          T* __restrict__ out,
                                          const uint8_t* ok, T* lev,
                                          size_t row, int c0, int NPP, int R,
                                          int L, int W) {
  const int base = c0 - (R - 1);
  const T id = identity<T, OP>();
  for (int s = threadIdx.x; s < W; s += blockDim.x)
    lev[s] = ok[s] ? x[row + base + s] : id;
  __syncthreads();
  for (int j = 1, w = 1; j < L; ++j, w <<= 1) {
    const T* prev = lev + (size_t)(j - 1) * W;
    T* cur = lev + (size_t)j * W;
    for (int s = threadIdx.x; s < W; s += blockDim.x)
      cur[s] = s >= w ? combine<T, OP>(prev[s - w], prev[s]) : id;
    __syncthreads();
  }
  const int c = c0 + threadIdx.x;
  if (c < NPP) {
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
  __syncthreads();  // the next leaf reuses the levels
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
    fold_rows_smem_kernel(Leaves lv, const uint8_t* __restrict__ valid,
                          int NPP, int R, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = COLS + R - 1;
  uint8_t* ok = smem_raw + (size_t)L * W * 4;
  const int c0 = blockIdx.y * COLS;
  const int base = c0 - (R - 1);
  const size_t row = (size_t)blockIdx.x * NPP;
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int c = base + s;
    ok[s] = c >= 0 && c < NPP && valid[row + c];
  }
  __syncthreads();
  for (int l = 0; l < lv.n; ++l) {
    if ((lv.int_mask >> l) & 1)
      smem_fold<int32_t, OP>(static_cast<const int32_t*>(pick(lv.x, l)),
                             static_cast<int32_t*>(pick(lv.out, l)), ok,
                             reinterpret_cast<int32_t*>(smem_raw), row, c0,
                             NPP, R, L, W);
    else
      smem_fold<float, OP>(static_cast<const float*>(pick(lv.x, l)),
                           static_cast<float*>(pick(lv.out, l)), ok,
                           reinterpret_cast<float*>(smem_raw), row, c0, NPP,
                           R, L, W);
  }
}

template <int OP, int R, int C>
int launch_fast(const Leaves& lv, const void* valid, int K, int NPP,
                cudaStream_t st) {
  static int blocks_per_sm = 0;  // resident blocks of this kernel an SM
  if (blocks_per_sm == 0) {
    int nb = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, fold_runs_kernel<OP, R, C>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    blocks_per_sm = nb > 0 ? nb : 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)K * NPP;
  const long long nruns = (N + C - 1) / C;
  long long blocks = (nruns + THREADS - 1) / THREADS;
  const long long wave = (long long)sms * blocks_per_sm;
  if (blocks > wave) blocks = wave;
  fold_runs_kernel<OP, R, C><<<(unsigned)blocks, THREADS, 0, st>>>(
      lv, static_cast<const uint8_t*>(valid), N, (long long)NPP, nruns);
  return (int)cudaGetLastError();
}

template <int OP, int C, int R = 1>
int dispatch_fast(int r, const Leaves& lv, const void* valid, int K, int NPP,
                  cudaStream_t st) {
  if constexpr (R > FAST_MAX_R) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (r == R) return launch_fast<OP, R, C>(lv, valid, K, NPP, st);
    return dispatch_fast<OP, C, R + 1>(r, lv, valid, K, NPP, st);
  }
}

template <int OP>
int launch_smem(const Leaves& lv, const void* valid, int K, int NPP, int R,
                cudaStream_t st) {
  int L = 1;
  while ((1 << L) <= R) ++L;  // levels 0..L-1 with 2^(L-1) <= R
  const int W = COLS + R - 1;
  const size_t smem = (size_t)L * W * 4 + W;
  const dim3 grid(K, (NPP + COLS - 1) / COLS);
  fold_rows_smem_kernel<OP><<<grid, THREADS, smem, st>>>(
      lv, static_cast<const uint8_t*>(valid), NPP, R, L);
  return (int)cudaGetLastError();
}

template <int OP>
int launch(bool fast, int run, const Leaves& lv, const void* valid, int K,
           int NPP, int R, cudaStream_t st) {
  if (!fast) return launch_smem<OP>(lv, valid, K, NPP, R, st);
  if (run == 4) return launch_fast<OP, 8, 4>(lv, valid, K, NPP, st);
  if (run == 16) return launch_fast<OP, 8, 16>(lv, valid, K, NPP, st);
  return dispatch_fast<OP, RUN>(R, lv, valid, K, NPP, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// x0..x3, o0..o3: [K, NPP] row-major leaves and their outputs, the first
// `nleaves` used; bit l of int_mask set: leaf l is int32, else float32.
// valid: [K, NPP] bool (one byte each); op: 0 sum, 1 max, 2 min;
// 1 <= R <= 512; run: outputs a thread of the register path, 8, or 4 or
// 16 at R = 8.
// Launches once on `stream`; returns the CUDA error, else 0.
extern "C" int wf_sliding_fold(const void* valid, const void* x0,
                               const void* x1, const void* x2, const void* x3,
                               void* o0, void* o1, void* o2, void* o3,
                               int nleaves, int int_mask, int K, int NPP,
                               int R, int op, int run, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > 512 || op < 0 || op > 2 || nleaves < 0 ||
      nleaves > MAX_LEAVES ||
      (run != RUN && !(R == 8 && (run == 4 || run == 16))))
    return (int)cudaErrorInvalidValue;
  if (K <= 0 || NPP <= 0 || nleaves == 0) return 0;
  Leaves lv;
  const void* xs[MAX_LEAVES] = {x0, x1, x2, x3};
  void* os[MAX_LEAVES] = {o0, o1, o2, o3};
  bool fast = R <= FAST_MAX_R && aligned16(valid);
  for (int l = 0; l < MAX_LEAVES; ++l) {
    lv.x[l] = xs[l];
    lv.out[l] = os[l];
    if (l < nleaves) fast = fast && aligned16(xs[l]) && aligned16(os[l]);
  }
  lv.n = nleaves;
  lv.int_mask = int_mask;
  if (op == OP_SUM) return launch<OP_SUM>(fast, run, lv, valid, K, NPP, R, st);
  if (op == OP_MAX) return launch<OP_MAX>(fast, run, lv, valid, K, NPP, R, st);
  return launch<OP_MIN>(fast, run, lv, valid, K, NPP, R, st);
}
