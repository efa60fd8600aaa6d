// K1: fan-in segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel orleans_tpu/ops/segment_reduce.py:
// segment_sum_pallas (body _seg_kernel), which computes
//     out[s, :] = sum_i [ids[i] == s] * values[i, :]
// as a blocked one-hot matmul on the MXU, accumulated in float32. Here the
// same function is a privatized scatter-add: the TPU's sequential grid
// carried the sum in its output block; Hopper's blocks run in parallel,
// so each block keeps its own S*D float32 partial sums in shared memory,
// walks a grid-strided chunk of the B*D message elements adding each one
// with a shared-memory atomicAdd, and flushes its partials to the global
// float32 output with one global atomicAdd per non-zero cell. Ids outside
// [0, S) (the -1 pad lanes) contribute nothing. Several shards fold in one
// launch: the input is `rows` rows of B lanes, and a lane of row r adds
// into segment r * S + id, so the output holds rows * S segments.
//
// What bounds it: bytes. The function reads each value and id once and
// writes S*D floats; at the multi-shard bench's fan-in (1.25M int32 lanes
// with their ids, S*D = 1024) that is about 10 MB, about 3 us at the
// H100 SXM's 3.35 TB/s. There is no arithmetic to speak of (one add per
// element). The design keeps the traffic at that minimum: the one-hot
// operand never exists, values and ids stream once with neighbouring
// threads on neighbouring addresses, and the only extra global traffic is
// the flush (blocks x S*D atomics, small beside B*D). Shared-memory
// atomics on a handful of hot segments are what can make it slower than
// the bound; that is measured, not assumed.
//
// Numerics: accumulation is float32, as on the TPU. Integer inputs are
// exact while every per-segment sum stays below 2^24, in any order.
// Float results depend on the order of the atomics, which changes from
// run to run: compare floats within rtol 1e-6 of sum |values| per segment.
//
// The caller zeroes `out`, allocates everything, and casts the float32
// result back to the values' dtype. S*D*4 bytes must fit in a block's
// shared memory (the Python wrapper checks; the launcher also refuses).

#include <cuda_runtime.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in per block on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                   float* __restrict__ out, long long B, int rows, int D,
                   int S) {
  extern __shared__ float acc[];
  const int cells = rows * S * D;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();

  const long long total = B * rows * (long long)D;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long lane = e / D;
    const int col = (int)(e - lane * D);
    const int s = __ldg(ids + lane);
    if ((unsigned)s < (unsigned)S) {
      const int seg = (int)(lane / B) * S + s;
      atomicAdd(&acc[seg * D + col], to_f32(values[e]));
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const float v = acc[c];
    if (v != 0.f) atomicAdd(&out[c], v);
  }
}

template <typename T>
int launch(const void* values, const int* ids, float* out, long long B,
           int rows, int D, int S, cudaStream_t stream) {
  const long long cells = (long long)rows * S * D;
  const size_t smem = (size_t)cells * sizeof(float);
  if (B < 0 || rows < 1 || D < 1 || S < 1 ||
      smem > (size_t)kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough blocks to fill the card, few enough that the per-block flush
  // (S*D atomics each) stays small beside the B*D element adds
  const long long elems = B * rows * (long long)D;
  long long want = (elems + kThreads * 16 - 1) / (kThreads * 16);
  long long cap = (long long)sms * 4;
  if (cells * 64 > elems) cap = sms;  // flush-heavy shapes: one wave
  const int grid = (int)(want < 1 ? 1 : (want > cap ? cap : want));
  segment_sum_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(values), ids, out, B, rows, D, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int oat_segment_sum_f32(const void* values, const int* ids, float* out,
                        long long B, int rows, int D, int S,
                        void* stream) {
  return launch<float>(values, ids, out, B, rows, D, S,
                        (cudaStream_t)stream);
}

int oat_segment_sum_i32(const void* values, const int* ids, float* out,
                        long long B, int rows, int D, int S,
                        void* stream) {
  return launch<int>(values, ids, out, B, rows, D, S,
                        (cudaStream_t)stream);
}

int oat_segment_sum_f16(const void* values, const int* ids, float* out,
                        long long B, int rows, int D, int S,
                        void* stream) {
  return launch<__half>(values, ids, out, B, rows, D, S,
                        (cudaStream_t)stream);
}

int oat_segment_sum_max_cells() { return kMaxSharedBytes / (int)sizeof(float); }

}  // extern "C"
