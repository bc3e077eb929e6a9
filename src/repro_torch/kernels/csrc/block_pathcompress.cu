// Tile-confined pointer doubling for Hopper (sm_90a).
//
// Replaces repro/kernels/block_pathcompress.py::block_pathcompress, the
// Pallas TPU kernel that runs `rounds` synchronous rounds of d <- d[d] on
// each tile [t * block, (t + 1) * block) of a pointer array.  A pointer that
// is negative or leaves its tile is a fixed point.  The tail past n reads as
// the -1 sentinel the TPU kernel pads with, so a pointer into [n, tile end)
// becomes -1 in the round that follows it.  The wrapper has already snapped
// `block` to min(block, next_pow2(n)), as the JAX entry point does.
//
// Bound: device-memory bytes.  The least traffic is one read and one write
// of the pointers (8 B each for int32 ids: 1.07 GB at n = 2^27, 0.321 ms
// at 3.35 TB/s).  Two launch configurations:
//   * shared (2 * block * sizeof(id) <= 227 KB, e.g. int32 block <= 29,056):
//     one CTA per tile loads the tile once into shared memory and runs
//     every round there, ping-pong between two buffers with one
//     __syncthreads a round, so each round reads only the previous round's
//     values whatever order the threads write in.  Device memory sees one
//     read and one write per pointer: the bound's traffic.
//   * global (larger tiles): one launch per round over the whole array,
//     ping-pong between the output and a scratch buffer the wrapper
//     allocates, so each round moves ~12 B/pointer (read, gather, write).
//
// The kernel allocates nothing; every entry point launches on the given
// stream and returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
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
__global__ void tile_round_global(const Id* __restrict__ src,
                                  Id* __restrict__ dst, int64_t n,
                                  int64_t block) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Id p = src[i];
    const int64_t base = i / block * block;
    Id q = p;
    if (p >= 0 && (int64_t)p >= base && (int64_t)p - base < block)
      q = (int64_t)p < n ? src[p] : (Id)-1;
    dst[i] = q;
  }
}

template <typename Id>
int run(const Id* d, Id* out, Id* scratch, int64_t n, int64_t block,
        int rounds, int shared, cudaStream_t stream) {
  if (n < 0 || block < 1 || rounds < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (rounds == 0)
    return cudaMemcpyAsync(out, d, (size_t)n * sizeof(Id),
                           cudaMemcpyDeviceToDevice, stream);
  cudaError_t err;
  if (shared) {
    const size_t bytes = 2 * (size_t)block * sizeof(Id);
    if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
    const int64_t tiles = (n + block - 1) / block;
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
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
  if (scratch == nullptr && rounds > 1) return cudaErrorInvalidValue;
  int64_t blocks = (n + kGlobalThreads - 1) / kGlobalThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the last round writes `out`: round r (1-based) writes out when
  // rounds - r is even, scratch otherwise
  const Id* src = d;
  for (int r = 1; r <= rounds; ++r) {
    Id* dst = (rounds - r) % 2 == 0 ? out : scratch;
    tile_round_global<Id><<<(int)blocks, kGlobalThreads, 0, stream>>>(
        src, dst, n, block);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// d, out: n ids; scratch: n ids or NULL (global configuration only, needed
// when rounds > 1).  shared: 1 for the shared-memory configuration, 0 for
// the global one.  Returns a cudaError_t.
int block_pathcompress_i32(const void* d, void* out, void* scratch,
                           int64_t n, int64_t block, int rounds, int shared,
                           void* stream) {
  return run<int32_t>(static_cast<const int32_t*>(d),
                      static_cast<int32_t*>(out),
                      static_cast<int32_t*>(scratch), n, block, rounds,
                      shared, static_cast<cudaStream_t>(stream));
}

int block_pathcompress_i64(const void* d, void* out, void* scratch,
                           int64_t n, int64_t block, int rounds, int shared,
                           void* stream) {
  return run<int64_t>(static_cast<const int64_t*>(d),
                      static_cast<int64_t*>(out),
                      static_cast<int64_t*>(scratch), n, block, rounds,
                      shared, static_cast<cudaStream_t>(stream));
}

const char* block_pathcompress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
