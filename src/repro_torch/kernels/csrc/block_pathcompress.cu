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
//     a streaming kernel.  Persistent CTAs (as many as fit on the SMs) walk
//     the tiles t, t + G, t + 2G, ...  Each keeps a ring of two tile stages
//     in shared memory; one thread fills them with 1-D bulk copies
//     (cp.async.bulk, completion on an mbarrier a stage), so the next tile
//     is in flight while the rounds run on the current one.  A thread
//     keeps its pointers in registers from round to round; a round gathers
//     from one shared buffer and writes the other (the stage and a spare:
//     ping-pong), then one barrier.  Tiles too large for a spare beside
//     two stages write back in place, with a second barrier; the largest,
//     whose stage buffers (padded to whole threads) do not fit twice, have
//     one stage.  A thread holds the stage positions t, t + T, ... (T
//     threads), so a warp's gathers of nearby pointers hit distinct banks.
//     After the last gather the stage is free and is refilled at once; the
//     result goes out from registers, a warp's 32 ids at a time to
//     contiguous addresses, and overlaps the next tile.  Device memory sees
//     one read and one write per pointer: the bound's traffic.
//   * global (larger tiles): one launch per round over the whole array,
//     ping-pong between the output and a scratch buffer the wrapper
//     allocates, so each round moves ~12 B/pointer (read, gather, write).
//
// Alignment.  A stage mirrors its tile's address modulo 16 bytes: tile
// element i sits at stage index i + shift, where shift is the tile start's
// offset in ids from the 16-byte boundary below it.  The 16-byte chunks
// that lie wholly inside the tile come in by one bulk copy; the ids of the
// first and last chunk, where the tile's start, its end or n cuts them,
// are loaded one by one by the threads that hold them.  So a base pointer
// or a tile start off the 16-byte grid (d[1:], block 1001) runs in the
// same kernel.
//
// The kernel allocates nothing; every entry point launches on the given
// stream and returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "resident.cuh"

namespace {

constexpr int kGlobalThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr size_t kMaxSharedBytes = 232448;  // sm_90 opt-in limit per block
constexpr int kMaxThreads = 1024;
constexpr int kTargetThreads = 256;         // threads of a CTA, where they do
constexpr int kMaxStages = 4;              // the ring's most stages
constexpr size_t kBarrierBytes = 16 * kMaxStages;  // one mbarrier a stage

// --- PTX: mbarriers and 1-D bulk copies -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` (0: none).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// bulk copies (async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- the shared configuration -----------------------------------------------

// Where tile t lies: its first id, its ids below n, its stage shift, the
// stage positions it spans ([0, ids): 16-byte chunks), and the positions
// [lo, hi) of the chunks that lie wholly inside its ids (the bulk copy).
template <typename Id>
struct Tile {
  static constexpr int kVec = 16 / sizeof(Id);  // ids a chunk
  int64_t base;
  int valid, shift, ids, lo, hi;

  __device__ Tile(const Id* d, int64_t t, int block, int64_t n) {
    base = t * block;
    valid = (int)(n - base < block ? n - base : block);
    shift = (int)(reinterpret_cast<uintptr_t>(d + base) % 16 / sizeof(Id));
    ids = (valid + shift + kVec - 1) / kVec * kVec;
    lo = shift ? kVec : 0;
    hi = (valid + shift) / kVec * kVec;
    if (hi < lo) hi = lo;
  }
};

template <typename Id>
__device__ __forceinline__ void fill_stage(const Id* d, Id* stage,
                                           uint64_t* bar, const Tile<Id>& g) {
  const uint32_t bytes = (uint32_t)((g.hi - g.lo) * sizeof(Id));
  mbar_arrive_expect(bar, bytes);
  if (bytes) bulk_load(stage + g.lo, d + g.base + g.lo - g.shift, bytes, bar);
}

// Launch bounds of tile_rounds_ring<., ., NT>: its most threads, and the
// CTAs an SM must hold (so at most 64 registers a thread).
template <int NT>
struct RingBounds {
  static constexpr int kThreads = NT > 0 ? NT : kMaxThreads;
  static constexpr int kMinBlocks = kMaxThreads / kThreads;
};

// EPT: stage positions a thread, t, t + T, t + 2T, ... for T threads, so
// a warp's gathers of nearby pointers fall in distinct banks and its
// stores to device memory are contiguous.  A thread keeps its pointers in
// registers from round to round.  Dynamic shared memory: kBarrierBytes of
// mbarriers, `stages` stages of `stage_ids` = T * EPT ids (every position
// of every thread, so no write needs a bounds test), and with `pingpong`
// one more buffer of `stage_ids` ids: a round then gathers from one buffer
// and writes the other, with one barrier; without it a round gathers,
// waits, writes back in place and waits again.  NT: T as a compile-time
// constant, or 0 for blockDim.x.
template <typename Id, int EPT, int NT>
__global__ void __launch_bounds__(RingBounds<NT>::kThreads,
                                  RingBounds<NT>::kMinBlocks)
    tile_rounds_ring(const Id* __restrict__ d, Id* __restrict__ out,
                     int64_t n, int block, int rounds, int stages,
                     int stage_ids, int64_t tiles, int pingpong) {
  using U = std::make_unsigned_t<Id>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Id* ring = reinterpret_cast<Id*>(smem + kBarrierBytes);
  Id* spare = ring + (size_t)stages * stage_ids;  // with pingpong
  const int T = NT ? NT : blockDim.x;
  const int64_t G = gridDim.x;
  const int64_t mine = (tiles - blockIdx.x + G - 1) / G;  // tiles of this CTA
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages && s < mine; ++s)
      fill_stage(d, ring + (size_t)s * stage_ids, bar + s,
                 Tile<Id>(d, blockIdx.x + s * G, block, n));
  }
  __syncthreads();

  for (int64_t j = 0; j < mine; ++j) {
    const int s = (int)(j % stages);
    Id* st = ring + (size_t)s * stage_ids;
    const Tile<Id> g(d, blockIdx.x + j * G, block, n);
    // pointers into the tile, as offsets from its start; a tile past the
    // largest id is out of every pointer's reach
    const bool reachable =
        sizeof(Id) == 8 || g.base <= (int64_t)INT32_MAX;
    const Id base = reachable ? (Id)g.base : (Id)0;
    mbar_wait(bar + s, (uint32_t)(j / stages) & 1);

    // the ids of the cut first and last chunks, one by one from device
    // memory
    if (g.lo > 0 || g.hi < g.ids) {
      bool wrote = false;
#pragma unroll
      for (int m = 0; m < EPT; ++m) {
        const int at = threadIdx.x + m * T;
        const int i = at - g.shift;
        if ((at < g.lo || at >= g.hi) && i >= 0 && i < g.valid) {
          st[at] = d[g.base + i];
          wrote = true;
        }
      }
      if (wrote) fence_proxy_async();
      __syncthreads();
    }

    Id cur[EPT];  // -1 at positions outside the tile's ids: fixed points
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int at = threadIdx.x + m * T;
      const int i = at - g.shift;
      cur[m] = i >= 0 && i < g.valid ? st[at] : (Id)-1;
    }
    Id* src = st;
    Id* dst = pingpong ? spare : st;
    for (int r = 0; r < rounds; ++r) {
      const bool write = pingpong && r + 1 < rounds;
#pragma unroll
      for (int m = 0; m < EPT; ++m) {
        const Id p = cur[m];
        const U to = (U)p - (U)base;
        if (reachable && p >= 0 && to < (U)block)
          cur[m] = to < (U)g.valid ? src[to + g.shift] : (Id)-1;  // -1 past n
        if (write) dst[threadIdx.x + m * T] = cur[m];
      }
      if (write && dst == st) fence_proxy_async();
      __syncthreads();  // every gather of this round is done
      if (r + 1 == rounds) break;
      if (pingpong) {
        Id* t = src;
        src = dst;
        dst = t;
      } else {
#pragma unroll
        for (int m = 0; m < EPT; ++m) st[threadIdx.x + m * T] = cur[m];
        fence_proxy_async();
        __syncthreads();
      }
    }
    // no thread reads this stage again: refill it with the tile `stages`
    // ahead, while the result leaves from registers
    if (threadIdx.x == 0 && j + stages < mine)
      fill_stage(d, st, bar + s,
                 Tile<Id>(d, blockIdx.x + (j + stages) * G, block, n));
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int i = threadIdx.x + m * T - g.shift;
      if (i >= 0 && i < g.valid) out[g.base + i] = cur[m];
    }
  }
}

// Launches tile_rounds_ring<Id, EPT, NT> on a persistent grid: as many
// CTAs as the SMs hold (resident.cuh), at most one a tile.
template <typename Id, int EPT, int NT>
cudaError_t launch_ring_ept(const Id* d, Id* out, int64_t n, int block,
                            int rounds, int stages, int pingpong,
                            int stage_ids, int threads,
                            cudaStream_t stream) {
  static resident::Cache cache;
  const size_t bytes =
      kBarrierBytes + (size_t)(stages + pingpong) * stage_ids * sizeof(Id);
  int slots;
  const cudaError_t err = resident::ctas(
      cache, reinterpret_cast<const void*>(tile_rounds_ring<Id, EPT, NT>),
      threads, bytes, (int)kMaxSharedBytes, &slots);
  if (err != cudaSuccess) return err;
  if (slots < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (n + block - 1) / block;
  const int64_t grid = tiles < slots ? tiles : slots;
  tile_rounds_ring<Id, EPT, NT><<<(unsigned)grid, threads, bytes, stream>>>(
      d, out, n, block, rounds, stages, stage_ids, tiles, pingpong);
  return cudaGetLastError();
}

// Ids of a tile's stage positions: whole 16-byte chunks, one chunk more
// for a tile off the 16-byte grid.
template <typename Id>
int tile_positions(const Id* d, int block) {
  constexpr int kVec = Tile<Id>::kVec;
  const bool aligned = reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                       block % kVec == 0;
  return ((block + kVec - 1) / kVec + (aligned ? 0 : 1)) * kVec;
}

// Threads of a CTA with `ept` stage positions a thread.
inline int ring_threads(int positions, int ept) {
  return ((positions + ept - 1) / ept + 31) / 32 * 32;
}

// The shared configuration with `stages` stages, `pingpong` (0 or 1) and
// `ept` stage positions a thread (1 to 32 for int32 ids, to 16 for int64);
// the threads follow.
template <typename Id>
cudaError_t launch_ring(const Id* d, Id* out, int64_t n, int block,
                        int rounds, int stages, int pingpong, int ept,
                        cudaStream_t stream) {
  const int threads = ring_threads(tile_positions(d, block), ept);
  const int ids = threads * ept;
  if (stages < 1 || stages > kMaxStages || threads > kMaxThreads ||
      (pingpong != 0 && pingpong != 1) ||
      kBarrierBytes + (size_t)(stages + pingpong) * ids * sizeof(Id) >
          kMaxSharedBytes)
    return cudaErrorInvalidValue;
// kTargetThreads threads (the common launch) as a compile-time constant,
// which turns every position's offset into an immediate
#define BPC_EPT(E)                                                          \
  case E:                                                                   \
    if (threads == kTargetThreads)                                          \
      return launch_ring_ept<Id, E, kTargetThreads>(                        \
          d, out, n, block, rounds, stages, pingpong, ids, threads, stream); \
    return launch_ring_ept<Id, E, 0>(d, out, n, block, rounds, stages,      \
                                     pingpong, ids, threads, stream);
  switch (ept) {
    BPC_EPT(1) BPC_EPT(2) BPC_EPT(4) BPC_EPT(8) BPC_EPT(16)
    case 32:
      if constexpr (sizeof(Id) == 4)
        return launch_ring_ept<Id, 32, 0>(d, out, n, block, rounds, stages,
                                          pingpong, ids, threads, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef BPC_EPT
}

// The shipped choice: the fewest positions a thread that keep a CTA within
// kTargetThreads threads (else within kMaxThreads); two stages, with a
// spare buffer for ping-pong rounds where three buffers fit in shared
// memory, else rounds in place, with one stage for the largest tiles.
template <typename Id>
cudaError_t run_shared(const Id* d, Id* out, int64_t n, int block,
                       int rounds, cudaStream_t stream) {
  const int positions = tile_positions(d, block);
  const int most = sizeof(Id) == 4 ? 32 : 16;
  int ept = 1;
  while (ept < most && (positions + ept - 1) / ept > kTargetThreads) ept *= 2;
  const size_t buffer = (size_t)ring_threads(positions, ept) * ept * sizeof(Id);
  const size_t fit = (kMaxSharedBytes - kBarrierBytes) / buffer;
  return launch_ring<Id>(d, out, n, block, rounds, fit >= 2 ? 2 : 1,
                         fit >= 3 ? 1 : 0, ept, stream);
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
    if (2 * (size_t)block * sizeof(Id) > kMaxSharedBytes)
      return cudaErrorInvalidValue;
    return run_shared<Id>(d, out, n, (int)block, rounds, stream);
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
