// K1: fan-in segment sum for Hopper (sm_90a), one launch per call.
//
// Replaces the TPU kernel orleans_tpu/ops/segment_reduce.py:
// segment_sum_pallas (body _seg_kernel), which computes
//     out[s, :] = sum_i [ids[i] == s] * values[i, :]
// as a blocked one-hot matmul on the MXU, accumulated in float32, the sum
// carried across the sequential grid in the output block. Hopper's blocks
// run in parallel, so here each block sums a slice of one row into a
// private shared-memory histogram and the row's last block combines them.
// The input is `rows` rows of B lanes, each folded on its own into S
// segments of D columns.
//
// What bounds it: bytes. The function reads each value and id once and
// writes S*D outputs per row; at the multi-shard bench's fan-in (8 rows
// x 156,256 int32 lanes, D = 1, 128 segments a row) that is 10 MB, 3 us
// at the H100 SXM's 3.35 TB/s; one add per element is no arithmetic to
// speak of. The design keeps to those bytes and to one device kernel:
//   - each block streams a contiguous slice of one row (32-bit index
//     math inside the row); for D = 1 it reads ids and values 16 bytes a
//     thread where the slice is aligned (a scalar tail, and scalar loads
//     where a row start is not aligned), four of each in flight per
//     thread;
//   - int32 values add into an int32 shared histogram with the native
//     shared-memory integer atomic (ATOMS.ADD; zero values are skipped).
//     Float values add into a float32 one; the shared-memory float atomic
//     is a compare-and-swap loop on this card, so the lanes of a warp
//     that share a cell first sum their values (__match_any_sync, then a
//     lane-ordered shuffle sum) and one lane adds the group's sum;
//   - with one block per row the block writes `out` itself; otherwise
//     each block writes its histogram to a scratch buffer, and the row's
//     last block (a per-row ticket counter in a buffer of its own, reset
//     by that block, so it needs no memset and the launch can be replayed
//     as it is)
//     sums the row's histograms in block order and writes `out` in the
//     values' dtype: no zeroing kernel, no cast kernel, and the order
//     across blocks is fixed.
//
// Numerics: float inputs accumulate in float32, as on the TPU; their sums
// depend on the order of the shared-memory atomics within a block, which
// changes from run to run: compare within rtol 1e-6 of sum |values| per
// segment plus one unit in the last place of the output. Integer inputs
// accumulate in int32 and are exact while each per-segment sum fits in
// int32, which contains the TPU kernel's promise (exact below 2^24, the
// float32 accumulator's limit); from 2^24 on the plain float32 version
// rounds and this kernel does not.
//
// The launch plan (lanes per block, blocks per row, scratch size) is the
// Python wrapper's (ops/segment_reduce.py: segment_sum_plan); the launcher
// checks it and refuses S*D cells that do not fit in shared memory.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
// 227 KB opt-in per block on sm_90, less room for static shared variables
constexpr int kMaxSharedBytes = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // 16-byte loads of ids and values in flight

// the accumulator type: int32 for int32 values, float32 otherwise
template <typename T> struct Acc { using type = float; };
template <> struct Acc<int> { using type = int; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ int to_acc(int v) { return v; }

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__half* o, float v) {
  *o = __float2half_rn(v);
}
__device__ __forceinline__ void store(int* o, int v) { *o = v; }

// four consecutive values in one load (the address is aligned to it)
__device__ __forceinline__ void load4(const int* p, int (&x)[4]) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void load4(const __half* p, float (&x)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Adds v into acc[cell] (cell -1: nothing). Called by all 32 lanes.
__device__ __forceinline__ void add(int* acc, int cell, int v) {
  if (cell >= 0 && v != 0) atomicAdd(acc + cell, v);
}
__device__ __forceinline__ void add(float* acc, int cell, float v) {
  const unsigned group = __match_any_sync(kFull, cell);
  const int most = (int)__reduce_max_sync(kFull, (unsigned)__popc(group));
  float sum = 0.f;
  unsigned m = group;
  for (int it = 0; it < most; ++it) {  // lane-ordered sum of the group
    const float x = __shfl_sync(kFull, v, m ? __ffs(m) - 1 : 0);
    if (m) {
      sum += x;
      m &= m - 1;
    }
  }
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  if (cell >= 0 && (group & below) == 0 && sum != 0.f)
    atomicAdd(acc + cell, sum);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                   T* __restrict__ out, unsigned* __restrict__ counters,
                   void* __restrict__ partials, int B, int D, int S,
                   int chunk, int blocks_per_row) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* acc = reinterpret_cast<A*>(smem_raw);  // [S * D]
  __shared__ int last_sh;
  const int cells = S * D;
  for (int c = threadIdx.x; c < cells; c += kThreads) acc[c] = A(0);
  __syncthreads();

  const int bpr = blocks_per_row;
  const int row = blockIdx.x / bpr, b = blockIdx.x - row * bpr;
  const long long start = (long long)b * chunk;
  const int n = (int)max(0ll, min((long long)chunk, (long long)B - start));
  const long long lane0 = (long long)row * B + start;
  const int* id = ids + lane0;
  const T* v = values + lane0 * D;

  // every loop below runs the same trips in every thread, so that the
  // warp-wide adds see all 32 lanes
  if (D == 1) {
    const bool vec =
        (reinterpret_cast<uintptr_t>(id) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(v) & (4 * sizeof(T) - 1)) == 0;
    const int n4 = vec ? n / 4 : 0;
    for (int q0 = 0; q0 < n4; q0 += kUnroll * kThreads) {
      int s[kUnroll][4];
      A x[kUnroll][4];
#pragma unroll
      for (int h = 0; h < kUnroll; ++h) {  // every load before any add
        const int q = q0 + h * kThreads + threadIdx.x;
        if (q < n4) {
          load4(id + 4 * q, s[h]);
          load4(v + 4 * q, x[h]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[h][j] = -1, x[h][j] = A(0);
        }
      }
#pragma unroll
      for (int h = 0; h < kUnroll; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          add(acc, (unsigned)s[h][j] < (unsigned)S ? s[h][j] : -1, x[h][j]);
    }
    for (int p0 = n4 * 4; p0 < n; p0 += kThreads) {
      const int p = p0 + threadIdx.x;
      int s = -1;
      A x = A(0);
      if (p < n) {
        s = __ldg(id + p);
        x = to_acc(v[p]);
      }
      add(acc, (unsigned)s < (unsigned)S ? s : -1, x);
    }
  } else {
    const int elems = n * D;
    for (int e0 = 0; e0 < elems; e0 += kThreads) {
      const int e = e0 + threadIdx.x;
      int cell = -1;
      A x = A(0);
      if (e < elems) {
        const int lane = e / D;
        const int s = __ldg(id + lane);
        if ((unsigned)s < (unsigned)S) {
          cell = s * D + (e - lane * D);
          x = to_acc(v[e]);
        }
      }
      add(acc, cell, x);
    }
  }
  __syncthreads();

  T* o = out + (long long)row * cells;
  if (bpr == 1) {
    for (int c = threadIdx.x; c < cells; c += kThreads) store(o + c, acc[c]);
    return;
  }
  // partials: [rows][bpr][cells] block histograms
  A* mine = static_cast<A*>(partials) + (long long)blockIdx.x * cells;
  for (int c = threadIdx.x; c < cells; c += kThreads) mine[c] = acc[c];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_sh = atomicAdd(&counters[row], 1u) == (unsigned)(bpr - 1);
    if (last_sh) counters[row] = 0;  // every block of the row has counted
  }
  __syncthreads();
  if (!last_sh) return;
  __threadfence();
  const A* part =
      static_cast<const A*>(partials) + (long long)row * bpr * cells;
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    A sum = A(0);
    for (int q = 0; q < bpr; ++q)
      sum += __ldcg(part + (long long)q * cells + c);
    store(o + c, sum);
  }
}

template <typename T>
int launch(const void* values, const int* ids, void* out, unsigned* counters,
           void* partials, int B, int rows, int D, int S, int chunk,
           int blocks_per_row, cudaStream_t stream) {
  static unsigned long long ready = 0;  // bit per device: attribute set
  const long long cells = (long long)S * D;
  const size_t smem = (size_t)cells * 4;
  const int bpr = blocks_per_row;
  if (B < 0 || rows < 1 || D < 1 || S < 1 || bpr < 1 || chunk < 4 ||
      chunk % 4 != 0 || (long long)chunk * bpr < B ||
      (long long)chunk * D > 0x7fffffffLL ||
      (long long)rows * bpr > 0x7fffffffLL ||
      smem > (size_t)kMaxSharedBytes ||
      (bpr > 1 && (counters == nullptr || partials == nullptr)))
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready & bit)) {
    e = cudaFuncSetAttribute(segment_sum_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
    if (e != cudaSuccess) return (int)e;
    ready |= bit;
  }
  segment_sum_kernel<T><<<rows * bpr, kThreads, smem, stream>>>(
      static_cast<const T*>(values), ids, static_cast<T*>(out), counters,
      partials, B, D, S, chunk, bpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// values: rows x B x D; ids: rows x B int32; out: rows x S x D in the
// values' dtype, written whole. When blocks_per_row > 1: counters, `rows`
// zeroed 32-bit words (the kernel leaves them zeroed), and partials,
// rows * blocks_per_row * S * D 32-bit words of any content; else both
// unused. The plan is segment_sum_plan's.
#define OAT_SEGMENT_SUM(name, T)                                          \
  int name(const void* values, const int* ids, void* out,                 \
           unsigned* counters, void* partials, int B, int rows, int D,    \
           int S, int chunk, int blocks_per_row, void* stream) {          \
    return launch<T>(values, ids, out, counters, partials, B, rows, D, S, \
                     chunk, blocks_per_row, (cudaStream_t)stream);        \
  }

OAT_SEGMENT_SUM(oat_segment_sum_f32, float)
OAT_SEGMENT_SUM(oat_segment_sum_i32, int)
OAT_SEGMENT_SUM(oat_segment_sum_f16, __half)

}  // extern "C"
