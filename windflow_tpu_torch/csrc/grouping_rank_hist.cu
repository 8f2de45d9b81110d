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
// launches and the cross-tile dependency bound it, not bandwidth.
//
// Design.  The Pallas kernel carries a running histogram across a
// SEQUENTIAL grid in VMEM scratch.  CUDA blocks run in no order, so the
// carry becomes passes over a [T, NB] table of per-tile counts:
//   1. tile_hist: one block per 256-lane tile counts its ids with
//      shared-memory atomics (counts do not depend on order) and writes
//      its row of the table;
//   2. segment_scan: per bucket, an exclusive scan over the tiles of a
//      32-tile segment, in place, plus each segment's total;
//   3. bucket_scan (one block): per bucket, an exclusive scan over the
//      segment totals (in place), the histogram, and the bucket starts;
//   4. rank_dest: the within-tile stable rank (each thread counts the
//      earlier lanes of its tile with its id, the same O(TILE^2) work as
//      the Pallas kernel's triangular matmul, here from shared memory),
//      plus the tile's and the segment's offsets and the bucket start.
// Everything is int32: no float rounding anywhere, so the result is
// bit-identical to grouping.dense_rank / order_and_hist.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;           // lanes per tile (LANE_TILE)
constexpr int SEG = 32;             // tiles per scan segment
constexpr int SCAN_THREADS = 1024;  // threads of the one-block bucket scan

__global__ void tile_hist_kernel(const int32_t* __restrict__ ids, int B,
                                 int NB, int32_t* __restrict__ tilehist) {
  extern __shared__ int32_t h[];
  const int t = blockIdx.x;
  for (int b = threadIdx.x; b < NB; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int i = t * TILE + threadIdx.x;
  if (i < B) {
    const int id = ids[i];
    if (id >= 0 && id < NB) atomicAdd(&h[id], 1);
  }
  __syncthreads();
  int32_t* row = tilehist + (size_t)t * NB;
  for (int b = threadIdx.x; b < NB; b += blockDim.x) row[b] = h[b];
}

__global__ void segment_scan_kernel(int32_t* __restrict__ tilehist, int T,
                                    int NB, int32_t* __restrict__ segsum) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (b >= NB) return;
  const int t0 = s * SEG;
  const int t1 = min(T, t0 + SEG);
  int32_t run = 0;
  for (int t = t0; t < t1; ++t) {
    const size_t k = (size_t)t * NB + b;
    const int32_t v = tilehist[k];
    tilehist[k] = run;
    run += v;
  }
  segsum[(size_t)s * NB + b] = run;
}

__global__ void bucket_scan_kernel(int32_t* __restrict__ segsum, int S,
                                   int NB, int32_t* __restrict__ hist,
                                   int32_t* __restrict__ bstart) {
  __shared__ int32_t part[SCAN_THREADS];
  const int per = (NB + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = min(NB, (int)threadIdx.x * per);
  const int b1 = min(NB, b0 + per);
  int32_t local = 0;
  for (int b = b0; b < b1; ++b) {
    int32_t run = 0;
    for (int s = 0; s < S; ++s) {
      const size_t k = (size_t)s * NB + b;
      const int32_t v = segsum[k];
      segsum[k] = run;
      run += v;
    }
    hist[b] = run;
    local += run;
  }
  part[threadIdx.x] = local;
  __syncthreads();
  // inclusive Hillis-Steele scan of the per-thread chunk totals
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const int32_t v = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int32_t run = part[threadIdx.x] - local;
  for (int b = b0; b < b1; ++b) {
    bstart[b] = run;
    run += hist[b];
  }
}

__global__ void rank_dest_kernel(const int32_t* __restrict__ ids, int B,
                                 int NB,
                                 const int32_t* __restrict__ tileoff,
                                 const int32_t* __restrict__ segoff,
                                 const int32_t* __restrict__ bstart,
                                 int32_t* __restrict__ dest,
                                 int32_t* __restrict__ rank) {
  __shared__ int32_t sid[TILE];
  const int t = blockIdx.x;
  const int i = t * TILE + threadIdx.x;
  const int id = i < B ? ids[i] : -1;
  sid[threadIdx.x] = id;
  __syncthreads();
  if (i >= B) return;
  if (id < 0 || id >= NB) {
    rank[i] = 0;
    dest[i] = 0;
    return;
  }
  int32_t within = 0;
  for (int j = 0; j < (int)threadIdx.x; ++j) within += (sid[j] == id);
  const int32_t r = within + tileoff[(size_t)t * NB + id]
      + segoff[(size_t)(t / SEG) * NB + id];
  rank[i] = r;
  dest[i] = r + bstart[id];
}

}  // namespace

// ids: int32 [B]; dest, rank: int32 [B]; hist, bstart: int32 [NB];
// tilehist: int32 [T * NB] and segsum: int32 [S * NB] scratch, with
// T = ceil(B / 256) and S = ceil(T / 32).  Launches on `stream`; returns
// the CUDA error of the first launch that failed, else 0.
extern "C" int wf_grouping_rank_hist(const void* ids, int B, int NB,
                                     void* dest, void* rank, void* hist,
                                     void* tilehist, void* segsum,
                                     void* bstart, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (B + TILE - 1) / TILE;
  const int S = (T + SEG - 1) / SEG;
  const int32_t* ids32 = static_cast<const int32_t*>(ids);
  int32_t* th = static_cast<int32_t*>(tilehist);
  int32_t* ss = static_cast<int32_t*>(segsum);
  int32_t* bs = static_cast<int32_t*>(bstart);
  cudaError_t err;
  tile_hist_kernel<<<T, TILE, NB * sizeof(int32_t), st>>>(ids32, B, NB, th);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  segment_scan_kernel<<<dim3((NB + 255) / 256, S), 256, 0, st>>>(th, T, NB,
                                                                  ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bucket_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      ss, S, NB, static_cast<int32_t*>(hist), bs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_dest_kernel<<<T, TILE, 0, st>>>(ids32, B, NB, th, ss, bs,
                                       static_cast<int32_t*>(dest),
                                       static_cast<int32_t*>(rank));
  return (int)cudaGetLastError();
}
