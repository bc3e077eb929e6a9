// The previous designs of the two pointer kernels, built only by
// pointer_kernels_ab.py to time them against the shipped ones in one
// process.  Never on a path of the port.
//
//   * prev_block_pathcompress_{i32,i64}: the shared configuration as it was
//     before the streaming redesign -- one 1024-thread CTA a tile, load,
//     ping-pong rounds and store one after another, cudaFuncSetAttribute
//     on every call.
//   * prev_steepest_neighbor: stencil.cuh's init kernel (kSteepest), which
//     steepest_neighbor.cu launched before its 2.5-D streaming stencil; the
//     fused kernel's init still runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../kernels/csrc/stencil.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // sm_90 opt-in limit per block

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    tile_rounds_shared(const Id* __restrict__ d, Id* __restrict__ out,
                       int64_t n, int block, int rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  Id* cur = reinterpret_cast<Id*>(smem);
  Id* nxt = cur + block;
  const int64_t base = (int64_t)blockIdx.x * block;
  for (int t = threadIdx.x; t < block; t += blockDim.x)
    cur[t] = base + t < n ? d[base + t] : (Id)-1;
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    for (int t = threadIdx.x; t < block; t += blockDim.x) {
      const Id p = cur[t];
      nxt[t] = (p >= 0 && (int64_t)p >= base && (int64_t)p - base < block)
                   ? cur[(int64_t)p - base]
                   : p;
    }
    __syncthreads();
    Id* s = cur;
    cur = nxt;
    nxt = s;
  }
  for (int t = threadIdx.x; t < block; t += blockDim.x)
    if (base + t < n) out[base + t] = cur[t];
}

template <typename Id>
int prev_run(const Id* d, Id* out, int64_t n, int64_t block, int rounds,
             cudaStream_t stream) {
  if (n <= 0 || block < 1 || rounds < 1) return cudaErrorInvalidValue;
  const size_t bytes = 2 * (size_t)block * sizeof(Id);
  if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int64_t tiles = (n + block - 1) / block;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           tile_rounds_shared<Id>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
      cudaSuccess)
    return err;
  const int threads =
      block < kThreads ? (int)((block + 31) / 32 * 32) : kThreads;
  tile_rounds_shared<Id><<<(unsigned)tiles, threads, bytes, stream>>>(
      d, out, n, (int)block, rounds);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The previous shared configuration: d, out n ids, rounds >= 1, two tiles
// of `block` ids within 227 KB.  Returns a cudaError_t.
int prev_block_pathcompress_i32(const void* d, void* out, int64_t n,
                                int64_t block, int rounds, void* stream) {
  return prev_run<int32_t>(static_cast<const int32_t*>(d),
                           static_cast<int32_t*>(out), n, block, rounds,
                           static_cast<cudaStream_t>(stream));
}

int prev_block_pathcompress_i64(const void* d, void* out, int64_t n,
                                int64_t block, int rounds, void* stream) {
  return prev_run<int64_t>(static_cast<const int64_t*>(d),
                           static_cast<int64_t*>(out), n, block, rounds,
                           static_cast<cudaStream_t>(stream));
}

// The previous steepest-neighbor kernel: order and out X*Y*Z int32, the
// offsets checked as steepest_neighbor.cu checks them.
int prev_steepest_neighbor(const void* order, void* out, int X, int Y, int Z,
                           const int* offsets, int connectivity,
                           void* stream) {
  if (!stencil::offsets_match(connectivity, offsets))
    return cudaErrorInvalidValue;
  return stencil::launch_init<stencil::kSteepest, int32_t>(
      connectivity, order, nullptr, static_cast<int32_t*>(out), X, Y, Z,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
