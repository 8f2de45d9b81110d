// Segmented grouping for the FFAT step: rank, histogram and counting-sort
// destinations of int ids in [0, NB).
//
// Replaces: windflow_tpu/kernels/pallas_ffat.py grouping_rank_hist (the
// Pallas TPU kernel behind order_hist).  For every lane i:
//   rank[i] = earlier lanes j < i with ids[j] == ids[i]   (arrival-stable)
//   hist[b] = lanes with id b
//   dest[i] = bucket_start[ids[i]] + rank[i]              (bucket_start =
//             exclusive prefix sum of hist)
// so inverting dest gives argsort(ids, stable=True).  Ids outside [0, NB)
// are not counted and get rank 0, dest 0 (the Pallas kernel's one-hot
// gives the same); callers pre-clamp, as the JAX package does.
//
// What bounds it on an H100: the bytes are tiny (ids in, dest and rank
// out: 12 bytes a lane, ~3 MB at 262,144 lanes -> ~1 us at 3.35 TB/s), so
// launches, DRAM round trips and the cross-tile dependency bound it.  The
// design keeps the per-tile count table small enough to live in L2 and
// takes three launches, none of them a serial pass on one block.
//
// Design.  The Pallas kernel carries a running histogram across a
// SEQUENTIAL grid in VMEM scratch.  CUDA blocks run in no order, so the
// carry becomes a [T, NB] table of per-tile counts, with tiles of TILE =
// 2,048 lanes (T = 128 at 262,144 lanes: 525 KB at NB = 1,025, in L2;
// 4,096-lane tiles would leave half of the 132 SMs idle in the two
// per-tile kernels):
//   1. tile_hist: one block a tile counts its ids with shared-memory
//      atomics (a count does not depend on their order, and the compiler
//      already aggregates a warp's increments of one address:
//      ATOMS.POPC.INC in the SASS, listed by chip_profile.py, so no
//      __match_any_sync here) and writes its row of the table;
//   2. tile_scan: per bucket, an exclusive scan over the tiles, in
//      place, plus the histogram: a block takes 32 buckets, each of its
//      16 warps a contiguous run of tiles, and the runs' totals are
//      scanned in shared memory;
//   3. rank_dest: one block a tile.  It scans the histogram into bucket
//      starts (a block-wide scan), then each warp walks its contiguous
//      128 lanes in 32-lane steps: a lane's rank within the warp is
//      __popc(__match_any_sync(id) & lanes below) plus the warp's
//      running count of that id (16-bit counts per warp and bucket in
//      shared memory, which the group's lowest lane advances).  An
//      exclusive scan over the warps, per bucket, gives each warp's
//      offset; rank = tile offset + warp offset + rank within the warp.
//   At NB = 4,096 the 16 warps' counts take 128 KB: opt-in dynamic
//   shared memory.
// Everything is integer: no float rounding anywhere, so the result is
// bit-identical to grouping.dense_rank / order_and_hist.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;             // threads a block (all kernels)
constexpr int NWARPS = THREADS / 32;
constexpr int STEPS = 4;                 // 32-lane steps a warp walks
constexpr int TILE = THREADS * STEPS;    // lanes a tile (2,048)
constexpr int MAX_NB = 4096;
constexpr unsigned FULL = 0xffffffffu;
// rank_dest shared memory: tile offsets + bucket starts (int32) and the
// warps' counts (uint16)
constexpr size_t RANK_SMEM_MAX = (size_t)MAX_NB * 8 + (size_t)NWARPS * MAX_NB * 2;

// the ids of a warp's STEPS steps (lane `lane` of each), -1 outside [0, NB)
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ ids,
                                         int B, int NB, int first,
                                         int (&id)[STEPS]) {
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int i = first + k * 32;
    const int v = i < B ? __ldg(ids + i) : -1;
    id[k] = (unsigned)v < (unsigned)NB ? v : -1;
  }
}

__global__ void __launch_bounds__(THREADS)
tile_hist_kernel(const int32_t* __restrict__ ids, int B, int NB,
                 int32_t* __restrict__ cnt) {
  extern __shared__ int32_t h[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < NB; b += THREADS) h[b] = 0;
  int id[STEPS];
  load_ids(ids, B, NB, blockIdx.x * TILE + warp * 32 * STEPS + lane, id);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < STEPS; ++k)
    if (id[k] >= 0) atomicAdd(&h[id[k]], 1);
  __syncthreads();
  int32_t* row = cnt + (size_t)blockIdx.x * NB;
  for (int b = threadIdx.x; b < NB; b += THREADS) row[b] = h[b];
}

__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(int32_t* __restrict__ cnt, int T, int NB,
                 int32_t* __restrict__ hist) {
  __shared__ int32_t part[NWARPS][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (T + NWARPS - 1) / NWARPS;
  const int t0 = min(T, g * per), t1 = min(T, t0 + per);
  int32_t sum = 0;
  if (b < NB) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) sum += cnt[(size_t)t * NB + b];
  }
  part[g][lane] = sum;
  __syncthreads();
  int32_t run = 0;
  for (int k = 0; k < g; ++k) run += part[k][lane];
  if (b >= NB) return;
  for (int t = t0; t < t1; ++t) {
    const size_t k = (size_t)t * NB + b;
    const int32_t v = cnt[k];
    cnt[k] = run;
    run += v;
  }
  if (g == NWARPS - 1) hist[b] = run;
}

__global__ void __launch_bounds__(THREADS)
rank_dest_kernel(const int32_t* __restrict__ ids, int B, int NB,
                 const int32_t* __restrict__ toff,
                 const int32_t* __restrict__ hist,
                 int32_t* __restrict__ dest, int32_t* __restrict__ rank) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* off = reinterpret_cast<int32_t*>(smem);  // [NB] tile offsets
  int32_t* bst = off + NB;                           // [NB] bucket starts
  uint16_t* wc = reinterpret_cast<uint16_t*>(bst + NB);  // [NWARPS][NB]
  __shared__ int32_t wsum[NWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  int id[STEPS];
  load_ids(ids, B, NB, t * TILE + warp * 32 * STEPS + lane, id);
  for (int b = threadIdx.x; b < NB; b += THREADS)
    off[b] = toff[(size_t)t * NB + b];
  for (int j = threadIdx.x; j < NWARPS * NB; j += THREADS) wc[j] = 0;
  // bucket starts: block-wide exclusive scan of hist, `per` buckets a thread
  const int per = (NB + THREADS - 1) / THREADS;
  const int b0 = min(NB, (int)threadIdx.x * per), b1 = min(NB, b0 + per);
  int32_t local = 0;
  for (int b = b0; b < b1; ++b) local += hist[b];
  int32_t incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int32_t run = incl - local;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int b = b0; b < b1; ++b) {
    bst[b] = run;
    run += hist[b];
  }
  // rank within the warp: earlier steps (the warp's running counts) plus
  // the lanes below in this step
  uint16_t* mine = wc + (size_t)warp * NB;
  const unsigned below = (1u << lane) - 1;
  int wr[STEPS];
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const unsigned peers = __match_any_sync(FULL, id[k]);
    wr[k] = id[k] >= 0 ? mine[id[k]] + __popc(peers & below) : 0;
    __syncwarp();
    if (id[k] >= 0 && (peers & below) == 0) mine[id[k]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // warp offsets: exclusive scan over the warps, per bucket
  for (int b = threadIdx.x; b < NB; b += THREADS) {
    int r = 0;
    for (int w = 0; w < NWARPS; ++w) {
      const int c = wc[(size_t)w * NB + b];
      wc[(size_t)w * NB + b] = (uint16_t)r;
      r += c;
    }
  }
  __syncthreads();
  const int first = t * TILE + warp * 32 * STEPS + lane;
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int i = first + k * 32;
    if (i >= B) break;
    if (id[k] < 0) {
      rank[i] = 0;
      dest[i] = 0;
    } else {
      const int32_t r = off[id[k]] + mine[id[k]] + wr[k];
      rank[i] = r;
      dest[i] = r + bst[id[k]];
    }
  }
}

}  // namespace

// ids: int32 [B]; dest, rank: int32 [B]; hist: int32 [NB]; tilecnt: int32
// [T * NB] scratch with T = ceil(B / 2048).  Launches the three kernels on
// `stream`; returns the CUDA error of the first launch that failed, else 0.
extern "C" int wf_grouping_rank_hist(const void* ids, int B, int NB,
                                     void* dest, void* rank, void* hist,
                                     void* tilecnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || NB < 1 || NB > MAX_NB) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      rank_dest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)RANK_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int T = (B + TILE - 1) / TILE;
  const int32_t* ids32 = static_cast<const int32_t*>(ids);
  int32_t* cnt = static_cast<int32_t*>(tilecnt);
  int32_t* h = static_cast<int32_t*>(hist);
  cudaError_t err;
  tile_hist_kernel<<<T, THREADS, NB * sizeof(int32_t), st>>>(ids32, B, NB, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_scan_kernel<<<(NB + 31) / 32, THREADS, 0, st>>>(cnt, T, NB, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (size_t)NB * 8 + (size_t)NWARPS * NB * 2;
  rank_dest_kernel<<<T, THREADS, smem, st>>>(ids32, B, NB, cnt, h,
                                             static_cast<int32_t*>(dest),
                                             static_cast<int32_t*>(rank));
  return (int)cudaGetLastError();
}
