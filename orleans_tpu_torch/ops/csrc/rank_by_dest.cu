// K2: within-destination rank for Hopper (sm_90a), one launch per call.
//
// Replaces the TPU kernel orleans_tpu/ops/route.py: rank_by_dest (body
// _prefix_kernel), which computes
//     rank[i] = #{ j < i : dest[j] == dest[i] }
// as L @ onehot(dest) on the MXU (L strictly lower triangular): O(B^2)
// multiply-adds into an f32 [B, S] counts table, then a gather at dest.
// On Hopper the same function is a counting scan in O(B) work. The input
// is `rows` rows of B lanes, each ranked on its own over its S
// destinations.
//
// What bounds it: bytes. The function reads B int32 dest and writes B
// int32 ranks per row; at the multi-shard bench's route (8 rows x 131,072
// lanes) that is 8.4 MB, 2.5 us at the H100 SXM's 3.35 TB/s. The design
// moves about that and nothing else through device memory:
//   - each block ranks one tile of one row (512 threads x 16 lanes):
//     32-bit index math inside the row, and the destination space is the
//     row's S;
//   - the tile comes in once, 16 bytes a thread where the row is aligned
//     (scalar where it is not, and for the tail), through shared memory,
//     so that each warp then takes 32 consecutive lanes per step; dest
//     stays in registers from counting to ranking, and each rank goes out
//     from its lane's register, 32 consecutive lanes a warp store;
//   - each lane's rank within its warp: __match_any_sync finds the lanes
//     of its destination and their leader bumps the warp's count in
//     shared memory (no atomics: groups differ). A count by bit-sliced
//     __ballot_sync for S < 16 read slower and spilled (PERF.md);
//   - a block-wide exclusive scan of the per-warp counts (16 lanes per
//     destination, __shfl_up_sync) gives each warp its offset and the
//     tile its total per destination;
//   - the tiles before this one in the row are summed through the thread
//     block cluster's distributed shared memory: each block stores its
//     totals into the later blocks of its cluster, then one cluster
//     barrier (the barrier that makes the cluster's shared memory safe to
//     touch is split around the tile's load). A cluster of up to 16 blocks
//     covers a row at the bench's shape, so no count leaves the SMs;
//   - where a row needs several clusters, each cluster publishes its
//     total per destination in a scratch buffer and every block waits for
//     the totals of the earlier clusters of its row, all at once (a
//     look-back that reads every predecessor in parallel instead of
//     walking a chain). Clusters take their order from a ticket counter,
//     so a cluster only waits on clusters already running.
//     The last block to finish zeroes the words it used and the counters,
//     so the scratch is zero at every call's start without a memset and
//     the launch can be replayed as it is (a CUDA graph).
// What holds it above the bound is latency, not bytes: one block of 16
// warps an SM walks load, count, exchange and store in turn (PERF.md).
// The result is exact int32 in every order of execution.
//
// A measurement build (scripts/torch_kernel_plans.py) defines
// RANK_PHASE_MARKS: thread 0 of each block then stamps %globaltimer as it
// enters each numbered phase and at its end, with its SM, for
// oat_rank_by_dest_phase_marks to copy out; the kernel is otherwise as it
// is.
//
// dest must lie in [0, S): a lane outside it gets rank 0 and is counted
// nowhere (the Python wrapper maps invalid lanes to a sink id first, as
// the TPU version requires). The launch plan (cluster size, clusters per
// row, scratch size) is the Python wrapper's
// (ops/route.py: rank_plan); the launcher checks it and refuses a plan
// that does not cover the row or does not fit in shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;  // per thread
constexpr int kTile = kLanes * kThreads;
constexpr int kMaxCluster = 16;
// 227 KB opt-in per block on sm_90, less room for static shared variables
constexpr int kMaxSharedBytes = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;
// look-back words: a cluster's total per destination in the low 32 bits,
// bit 32 set once it is there
constexpr unsigned long long kReady = 1ull << 32;

// stage [kTile] | hist [kWarps][S] | incoming [cs][S] | tile_cnt [S]
// | base [S]
size_t shared_bytes(int S, int cs) {
  return ((size_t)kTile + (size_t)(kWarps + cs + 2) * S) * sizeof(int);
}

#ifdef RANK_PHASE_MARKS
constexpr int kMarkedBlocks = 4096;
constexpr int kMarks = 10;  // phases 0-7, the end, the SM
__device__ unsigned long long phase_marks[kMarkedBlocks * kMarks];
__device__ __forceinline__ void mark(int i) {
  if (threadIdx.x != 0 || blockIdx.x >= kMarkedBlocks) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  phase_marks[blockIdx.x * kMarks + i] = t;
  if (i == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    phase_marks[blockIdx.x * kMarks + kMarks - 1] = sm;
  }
}
#define RANK_MARK(i) mark(i)
#define RANK_MARK_END() \
  do {                  \
    __syncthreads();    \
    mark(8);            \
  } while (0)
#else
#define RANK_MARK(i)
#define RANK_MARK_END()
#endif

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
rank_by_dest_kernel(const int* __restrict__ dest, int* __restrict__ rank,
                    unsigned long long* __restrict__ scratch, int B, int S,
                    int clusters_per_row) {
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  const int cpr = clusters_per_row;
  int* stage = smem;                   // the tile's dest
  int* hist = stage + kTile;           // [kWarps][S] counts, then offsets
  int* incoming = hist + kWarps * S;   // [cs][S] earlier tiles' totals
  int* tile_cnt = incoming + cs * S;   // [S] the tile's total per dest
  int* base = tile_cnt + S;            // [S] lanes of earlier tiles
  __shared__ int ordinal_sh, last_sh;
  RANK_MARK(0);

  // 0. the cluster's place in its row. Distributed shared memory may be
  // touched only once every block of the cluster runs: with one cluster a
  // row that barrier is split around the load; with a chain, the ticket
  // that orders the clusters crosses it.
  int ordinal = blockIdx.x / cs;
  if (cpr > 1) {
    if (crank == 0 && threadIdx.x == 0)
      ordinal_sh = (int)atomicAdd(&scratch[0], 1ull);
    cluster.sync();
    ordinal = *cluster.map_shared_rank(&ordinal_sh, 0);
  } else {
    cluster_arrive_relaxed();
  }
  const int row = ordinal / cpr, k = ordinal - row * cpr;
  const long long start = (long long)(k * cs + crank) * kTile;
  const int n = (int)max(0ll, min((long long)kTile, (long long)B - start));
  const long long off = (long long)row * B + start;
  const int* src = dest + off;
  int* dst = rank + off;

  RANK_MARK(1);
  // 1. the tile into shared memory, 16 bytes a thread where aligned
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int n4 = vec ? n / 4 : 0;
  if (n4 == kTile / 4) {
    int4 q[kLanes / 4];
#pragma unroll
    for (int j = 0; j < kLanes / 4; ++j)
      q[j] = __ldg(reinterpret_cast<const int4*>(src) + j * kThreads +
                   threadIdx.x);
#pragma unroll
    for (int j = 0; j < kLanes / 4; ++j)
      reinterpret_cast<int4*>(stage)[j * kThreads + threadIdx.x] = q[j];
  } else {
    for (int j = threadIdx.x; j < n4; j += kThreads)
      reinterpret_cast<int4*>(stage)[j] =
          __ldg(reinterpret_cast<const int4*>(src) + j);
    for (int p = n4 * 4 + threadIdx.x; p < n; p += kThreads)
      stage[p] = __ldg(src + p);
  }
  for (int c = threadIdx.x; c < kWarps * S; c += kThreads) hist[c] = 0;
  __syncthreads();

  RANK_MARK(2);
  // 2. count per warp, and each lane's rank within its warp: 32 lanes a
  // step, kLanes steps. Per lane, dr = rank in the warp << 16 | (dest + 1).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  static_assert(32 * kLanes < (1 << 15), "a warp's rank fits in 15 bits");
  int dr[kLanes];
  int* my_hist = hist + warp * S;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const int p = (warp * kLanes + i) * 32 + lane;
    int x = p < n ? stage[p] : -1;
    if ((unsigned)x >= (unsigned)S) x = -1;
    const unsigned group = __match_any_sync(kFull, x);
    const int leader = __ffs(group) - 1;
    int before = 0;
    if (lane == leader && x >= 0) {
      before = my_hist[x];
      my_hist[x] = before + __popc(group);
    }
    before = __shfl_sync(kFull, before, leader);
    dr[i] = (before + __popc(group & below)) << 16 | (x + 1);
    __syncwarp();  // the next step's leader may read this step's count
  }
  __syncthreads();

  RANK_MARK(3);
  // 3. exclusive scan of the per-warp counts, kWarps lanes per destination
  static_assert(32 % kWarps == 0, "a destination's warps share one warp");
  for (int t0 = 0; t0 < kWarps * S; t0 += kThreads) {
    const int t = t0 + threadIdx.x, c = t / kWarps, w = t % kWarps;
    const bool ok = t < kWarps * S;
    const int x = ok ? hist[w * S + c] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o, kWarps);
      if (w >= o) incl += y;
    }
    if (ok) {
      hist[w * S + c] = incl - x;
      if (w == kWarps - 1) tile_cnt[c] = incl;
    }
  }
  __syncthreads();

  RANK_MARK(4);
  // 4. each tile's totals into the later tiles of its cluster (remote
  // stores, no round trip), then one barrier
  if (cpr == 1) cluster_wait();
  for (int t = threadIdx.x; t < (cs - 1 - crank) * S; t += kThreads) {
    const int q = crank + 1 + t / S, c = t % S;
    cluster.map_shared_rank(incoming, q)[crank * S + c] = tile_cnt[c];
  }
  cluster.sync();

  RANK_MARK(5);
  // 5. lanes of earlier tiles: the cluster's, then earlier clusters'.
  // The cluster's last block publishes the cluster's total; every block
  // waits for the totals of all earlier clusters of its row at once.
  unsigned long long* flags =
      scratch + 2 + (long long)(row * cpr) * S;  // [cpr][S] of this row
  for (int c = threadIdx.x; c < S; c += kThreads) {
    int pre = 0;
    for (int q = 0; q < crank; ++q) pre += incoming[q * S + c];
    if (cpr > 1 && crank == cs - 1)
      reinterpret_cast<volatile unsigned long long*>(flags)[k * S + c] =
          kReady | (unsigned)(pre + tile_cnt[c]);
    base[c] = pre;
  }
  if (cpr > 1) {
    __syncthreads();
    volatile unsigned long long* f = flags;
    for (int t = threadIdx.x; t < k * S; t += kThreads) {
      unsigned long long w;
      while (((w = f[t]) >> 32) == 0) __nanosleep(20);
      atomicAdd(&base[t % S], (int)(unsigned)w);
    }
  }
  __syncthreads();

  RANK_MARK(6);
  // 6. the last block to get here leaves the scratch zeroed
  if (cpr > 1) {
    if (threadIdx.x == 0) {
      __threadfence();
      last_sh = atomicAdd(&scratch[1], 1ull) == gridDim.x - 1;
    }
    __syncthreads();
    if (last_sh) {
      __threadfence();
      const long long words = (long long)(gridDim.x / cs) * S;
      for (long long c = threadIdx.x; c < words; c += kThreads)
        scratch[2 + c] = 0;
      if (threadIdx.x == 0) scratch[0] = scratch[1] = 0;
    }
  }

  RANK_MARK(7);
  // 7. each warp's offsets gain the tile's, then each lane's rank goes
  // out from its registers, 32 consecutive lanes a store
  for (int t = threadIdx.x; t < kWarps * S; t += kThreads)
    hist[t] += base[t % S];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const int p = (warp * kLanes + i) * 32 + lane;
    const int d = (dr[i] & 0xffff) - 1;
    if (p < n) dst[p] = d >= 0 ? (dr[i] >> 16) + hist[warp * S + d] : 0;
  }
  RANK_MARK_END();
}

// Sets the kernel's attributes once per device (bit `device` of `ready`).
cudaError_t prepare() {
  static unsigned long long ready = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (device & 63);
  if (ready & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(rank_by_dest_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSharedBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rank_by_dest_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready |= bit;
  return e;
}

cudaLaunchConfig_t config(int grid, int S, int cs, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shared_bytes(S, cs);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// dest, rank: rows x B int32. scratch: 2 + rows * clusters_per_row * S
// zeroed 64-bit words when clusters_per_row > 1 (the kernel leaves them
// zeroed), else unused. The plan is ops/route.py's rank_plan.
int oat_rank_by_dest(const int* dest, int* rank, unsigned long long* scratch,
                     int B, int rows, int S, int cluster_size,
                     int clusters_per_row, void* stream_ptr) {
  const int cs = cluster_size, cpr = clusters_per_row;
  if (B < 0 || rows < 1 || S < 1 || cs < 1 || cs > kMaxCluster || cpr < 1 ||
      (long long)kTile * cs * cpr < B ||
      (long long)rows * cpr * cs > 0x7fffffffLL ||
      shared_bytes(S, cs) > (size_t)kMaxSharedBytes ||
      (cpr > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(rows * cpr * cs, S, cs, (cudaStream_t)stream_ptr, &attr);
  e = cudaLaunchKernelEx(&cfg, rank_by_dest_kernel, dest, rank, scratch, B,
                         S, cpr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The largest cluster (16 or 8) that the card can hold at S destinations:
// 16 needs the non-portable cluster size.
int oat_rank_by_dest_max_cluster(int S) {
  if (shared_bytes(S, kMaxCluster) > (size_t)kMaxSharedBytes ||
      prepare() != cudaSuccess) {
    cudaGetLastError();
    return 8;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(kMaxCluster, S, kMaxCluster, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, rank_by_dest_kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 8;
  }
  return clusters > 0 ? kMaxCluster : 8;
}

#ifdef RANK_PHASE_MARKS
// The marks of the last launch's first `blocks` blocks into host memory:
// per block, the times at phases 0-7 and at the end, then its SM.
int oat_rank_by_dest_phase_marks(unsigned long long* host, int blocks) {
  if (blocks < 0 || blocks > kMarkedBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(
      host, phase_marks, sizeof(unsigned long long) * kMarks * blocks);
}
#endif

}  // extern "C"
