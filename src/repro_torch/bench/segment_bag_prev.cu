// The previous design of the sum EmbeddingBag kernel (one warp a bag; the
// lanes load 32 ids at once and broadcast them with shuffles, each lane
// sums one fp32 column, one 4- or 2-byte load a lane a row), built only by
// segment_bag_ab.py to time it against the shipped kernel in one process.
// Never on a path of the port.  Entry points: prev_segment_bag_{f32,bf16}_
// {i32,i64}, with the shipped entry points' arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 bags per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ table, const I* __restrict__ ids,
               T* __restrict__ out, int64_t V, int D, int64_t B, int L) {
  const int64_t bag = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (bag >= B) return;  // whole warps leave together
  const I* bag_ids = ids + bag * L;
  for (int d0 = 0; d0 < D; d0 += 32) {  // warp-uniform loop bounds
    const int d = d0 + lane;
    float acc = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int64_t mine = l0 + lane < L ? (int64_t)bag_ids[l0 + lane] : -1;
      const int cnt = L - l0 < 32 ? L - l0 : 32;
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) {
        const int64_t id = __shfl_sync(kFull, mine, j);
        if (id >= 0 && id < V && d < D) acc += to_float(table[id * D + d]);
      }
    }
    if (d < D) out[bag * D + d] = from_float<T>(acc);
  }
}

template <typename T, typename I>
int run(const void* table, const void* ids, void* out, int64_t V, int D,
        int64_t B, int L, cudaStream_t stream) {
  if (V < 0 || D < 0 || B < 0 || L < 0) return cudaErrorInvalidValue;
  if (B == 0 || D == 0) return cudaSuccess;
  const int64_t blocks = (B * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  bag_kernel<T, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const I*>(ids),
      static_cast<T*>(out), V, D, B, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table: V*D rows of float32 or bfloat16; ids: B*L int32 or int64;
// out: B*D of the table's type.  Returns a cudaError_t.
int prev_segment_bag_f32_i32(const void* table, const void* ids,
                             void* out, int64_t V, int D,
                             int64_t B, int L, void* stream) {
  return run<float, int32_t>(table, ids, out, V, D, B, L,
                             static_cast<cudaStream_t>(stream));
}
int prev_segment_bag_f32_i64(const void* table, const void* ids,
                             void* out, int64_t V, int D,
                             int64_t B, int L, void* stream) {
  return run<float, int64_t>(table, ids, out, V, D, B, L,
                             static_cast<cudaStream_t>(stream));
}
int prev_segment_bag_bf16_i32(const void* table, const void* ids,
                              void* out, int64_t V, int D,
                              int64_t B, int L, void* stream) {
  return run<__nv_bfloat16, int32_t>(table, ids, out, V, D, B, L,
                                     static_cast<cudaStream_t>(stream));
}
int prev_segment_bag_bf16_i64(const void* table, const void* ids,
                              void* out, int64_t V, int D,
                              int64_t B, int L, void* stream) {
  return run<__nv_bfloat16, int64_t>(table, ids, out, V, D, B, L,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
