// Sum EmbeddingBag (gather + per-bag sum) for Hopper (sm_90a).
//
// Replaces repro/kernels/segment_bag.py::segment_bag, the Pallas TPU kernel
// that sums, for each bag b of a (B, L) id array, the table rows of its ids.
// An id contributes its row only if it lies in [0, V): -1 pads, other
// negative ids and ids >= V fall in no vocab tile of the TPU kernel and add
// nothing; this kernel reads no row outside the table.  Sums accumulate in
// fp32 and are cast to the table's dtype once (round to nearest even for
// bf16, as torch's .to(torch.bfloat16) rounds).
//
// The TPU kernel sweeps the vocabulary in tiles because a TPU cannot chase
// rows; a GPU gathers rows directly.  One warp per bag: the lanes load 32 of
// the bag's ids at once and broadcast them with shuffles, and each lane
// keeps the fp32 sum of one column of the row (lanes split D; D > 32 takes
// more passes over the ids).  Rows of D = 32 fp32 are one 128-byte line.
// The summation order (ids in bag order) differs from the TPU kernel's
// (per vocab tile, then across tiles): the tests compare within 1e-5 for
// fp32 and 3e-2 for bf16.
//
// Bound: device-memory bytes: the ids once, every distinct table row the
// ids name once, and the (B, D) output once.  This design reads a row once
// per reference (bags that share a row read it again, from L2 when it is
// still there).
//
// The kernel allocates nothing; every entry point launches on the given
// stream and returns a cudaError_t (0 on success).

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
int segment_bag_f32_i32(const void* table, const void* ids, void* out,
                        int64_t V, int D, int64_t B, int L, void* stream) {
  return run<float, int32_t>(table, ids, out, V, D, B, L,
                             static_cast<cudaStream_t>(stream));
}
int segment_bag_f32_i64(const void* table, const void* ids, void* out,
                        int64_t V, int D, int64_t B, int L, void* stream) {
  return run<float, int64_t>(table, ids, out, V, D, B, L,
                             static_cast<cudaStream_t>(stream));
}
int segment_bag_bf16_i32(const void* table, const void* ids, void* out,
                         int64_t V, int D, int64_t B, int L, void* stream) {
  return run<__nv_bfloat16, int32_t>(table, ids, out, V, D, B, L,
                                     static_cast<cudaStream_t>(stream));
}
int segment_bag_bf16_i64(const void* table, const void* ids, void* out,
                         int64_t V, int D, int64_t B, int L, void* stream) {
  return run<__nv_bfloat16, int64_t>(table, ids, out, V, D, B, L,
                                     static_cast<cudaStream_t>(stream));
}

const char* segment_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
