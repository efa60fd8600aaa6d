// K2: within-destination rank for Hopper (sm_90a).
//
// Replaces the TPU kernel orleans_tpu/ops/route.py: rank_by_dest (body
// _prefix_kernel), which computes
//     rank[i] = #{ j < i : dest[j] == dest[i] }
// as L @ onehot(dest) on the MXU (L strictly lower triangular): O(B^2)
// multiply-adds into an f32 [B, S] counts table, then a gather at dest.
// On Hopper the same function is a counting scan in O(B*S / 1024 + B)
// work, in three passes over tiles of 1024 lanes (one block each):
//   1. per-tile histograms, counts[d][tile] (shared-memory atomics, one
//      per group of equal lanes in a warp, found with __match_any_sync);
//   2. an exclusive scan over tiles for each destination (one block per
//      destination), in place;
//   3. rank = scanned count of earlier tiles + count in earlier warps of
//      the tile (per-warp histograms in shared memory) + the lane's rank
//      within its warp, __popc(match mask & lanes below it).
// The result is exact int32 in every order of execution. Several shards
// rank in one launch: the input is `rows` rows of B lanes, and a lane of
// row r with dest d counts in destination r * S + d, so each row is ranked
// on its own over rows * S destinations in all.
//
// What bounds it: bytes. The function reads B int32 dest and writes B
// int32 ranks; at the multi-shard bench's route (8 shards x 131,072 lanes
// in one launch) that is 1,048,576 x 8 B, about 8.4 MB, about 2.5 us at
// the H100 SXM's 3.35 TB/s. The design reads dest twice (passes 1 and 3;
// the second read mostly hits the 50 MB L2) and moves S x B/1024 counts
// in between, small beside B. Three dependent launches and the per-tile
// zeroing of 32 x S shared counters are its fixed costs.
//
// dest must lie in [0, S): a lane outside it gets rank 0 and is counted
// nowhere (the Python wrapper maps invalid lanes to a sink id first, as
// the TPU version requires). rows * S is bounded by 32 x rows * S x 4
// bytes of shared memory per block; the launcher refuses more.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // lanes per block in passes 1 and 3
constexpr int kWarps = kTile / 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in per block on sm_90
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The lane's destination over all rows, or -1 for a padding lane or a
// dest outside [0, S).
__device__ __forceinline__ int row_dest(const int* __restrict__ dest,
                                        long long i, long long total,
                                        long long B, int S) {
  if (i >= total) return -1;
  const int d = dest[i];
  return (unsigned)d < (unsigned)S ? (int)(i / B) * S + d : -1;
}

__global__ void __launch_bounds__(kTile)
rank_histogram(const int* __restrict__ dest, int* __restrict__ counts,
               long long total, long long B, int S, int n_dests,
               int n_tiles) {
  extern __shared__ int hist[];  // [n_dests]
  for (int c = threadIdx.x; c < n_dests; c += blockDim.x) hist[c] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const int d = row_dest(dest, i, total, B, S);
  const unsigned group = __match_any_sync(kFull, d);
  if (d >= 0 && (group & lanemask_lt()) == 0) atomicAdd(&hist[d], __popc(group));
  __syncthreads();
  for (int c = threadIdx.x; c < n_dests; c += blockDim.x)
    counts[(long long)c * n_tiles + blockIdx.x] = hist[c];
}

// Exclusive scan of one destination's row counts[d][0:n_tiles], in place.
__global__ void __launch_bounds__(kTile)
rank_scan_tiles(int* __restrict__ counts, int n_tiles) {
  __shared__ int warp_incl[kWarps];
  __shared__ int carry;
  int* row = counts + (long long)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_tiles; base += kTile) {
    const int j = base + threadIdx.x;
    const int v = j < n_tiles ? row[j] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_incl[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? warp_incl[warp - 1] : 0) + x - v;
    if (j < n_tiles) row[j] = before;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == 0) carry += warp_incl[kWarps - 1];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTile)
rank_within_tile(const int* __restrict__ dest, const int* __restrict__ counts,
                 int* __restrict__ rank, long long total, long long B, int S,
                 int n_dests, int n_tiles) {
  extern __shared__ int warp_hist[];  // [kWarps][n_dests]
  for (int c = threadIdx.x; c < kWarps * n_dests; c += blockDim.x)
    warp_hist[c] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const int d = row_dest(dest, i, total, B, S);
  const unsigned group = __match_any_sync(kFull, d);
  const int in_warp = __popc(group & lanemask_lt());
  if (d >= 0 && in_warp == 0) warp_hist[warp * n_dests + d] = __popc(group);
  __syncthreads();
  if (i < total) {
    int r = 0;
    if (d >= 0) {
      r = counts[(long long)d * n_tiles + blockIdx.x] + in_warp;
      for (int w = 0; w < warp; ++w) r += warp_hist[w * n_dests + d];
    }
    rank[i] = r;
  }
}

}  // namespace

extern "C" {

// dest: rows x B int32; counts: int32 scratch of rows * S * ceil(rows * B
// / 1024) cells, allocated by the caller.
int oat_rank_by_dest(const int* dest, int* rank, int* counts, long long B,
                     int rows, int S, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n_dests_ll = (long long)rows * S;
  const size_t smem = (size_t)kWarps * n_dests_ll * sizeof(int);
  if (B < 0 || rows < 1 || S < 1 || smem > (size_t)kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  const long long total = B * rows;
  if (total == 0) return (int)cudaSuccess;
  const int n_dests = (int)n_dests_ll;
  const long long tiles = (total + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)tiles;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_within_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rank_histogram<<<n_tiles, kTile, n_dests * sizeof(int), stream>>>(
      dest, counts, total, B, S, n_dests, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rank_scan_tiles<<<n_dests, kTile, 0, stream>>>(counts, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rank_within_tile<<<n_tiles, kTile, smem, stream>>>(
      dest, counts, rank, total, B, S, n_dests, n_tiles);
  return (int)cudaGetLastError();
}

int oat_rank_by_dest_max_dests() {
  return kMaxSharedBytes / (kWarps * (int)sizeof(int));
}

}  // extern "C"
