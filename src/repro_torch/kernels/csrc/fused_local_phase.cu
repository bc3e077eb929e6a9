// Fused block-local phase of DPC for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_local_phase.py::fused_local_phase, the Pallas
// TPU kernel that the JAX package's Morse-Smale and connected-components
// queries run as their block-local phase.  It computes what that kernel
// computes, bit for bit: the pointers AND the round count for the tile
// (block_x, Y, Z).
//
//   1. Init, one thread per voxel.  mode 0 (manifold): the steepest
//      neighbor -- self first, then the offsets in the order of
//      repro_torch/core/steepest.py, a candidate replacing the best only if
//      strictly greater (jnp.argmax's first-max-wins).  mode 1 (cc): the
//      largest masked neighbor id including self, -1 for unmasked voxels.
//      The optional self_mask forces (masked) voxels to point at themselves.
//      The TPU kernel reads the x-neighbours across slab boundaries as halo
//      planes, so the init is a plain global stencil; out-of-grid neighbours
//      are skipped (the TPU's inert fill never wins).  A ragged X needs no
//      padding: a short last tile gives the pointers and rounds of the TPU
//      kernel's pinned pad rows.
//   2. Saturation: synchronous pointer doubling src -> dst, confined to the
//      voxel's own x-slab id range; negative and out-of-slab pointers are
//      fixed.  A round sets a device flag on any change, and the host loop
//      stops after the first round that changes nothing or at max_rounds.
//      Updates are not in place: in-place jumping reaches the same fixpoint
//      in a different number of rounds.  Every slab has the same round cap
//      and a converged slab is a fixed point of further rounds, so the
//      global loop count is the TPU kernel's max over slabs.
//
// Bound: device-memory bytes.  The least traffic is one read of the field
// (4 B/voxel order, 1 B/voxel mask), one write of the pointers (4 B/voxel
// int32) and one read of the optional self_mask (1 B/voxel).  This simple
// design pays about 12 B/voxel on each saturation round (read src, gather
// src[src], write dst) and one host read of the flag per round; at 512^3
// the slab holds tsize = 8*512*512 = 2,097,152 voxels, so max_rounds = 22.
// Keeping a slab in shared memory (227 KB a block, so Y and Z would be tiled
// too) would change the round count, which the reference fixes; that is a
// redesign for later.
//
// The kernel allocates nothing: the caller passes the output, a scratch
// buffer of the same size and type, and a device int flag.  Every entry
// point runs on the given stream and returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 26;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

struct Offsets {
  int n;
  int8_t d[kMaxOffsets][3];
};

template <typename Id>
__global__ void init_kernel(const void* __restrict__ field,
                            const uint8_t* __restrict__ self_mask,
                            Id* __restrict__ out, int mode, int X, int Y,
                            int Z, Offsets offs) {
  const int64_t n = (int64_t)X * Y * Z;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // the loop index is 64-bit so that i + stride cannot wrap; the id
  // arithmetic below runs in Id (32-bit divisions when ids are int32)
  for (int64_t ii = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; ii < n;
       ii += stride) {
    const Id i = (Id)ii;
    const int z = (int)(i % Z);
    const Id xy = i / Z;
    const int y = (int)(xy % Y);
    const int x = (int)(xy / Y);
    Id best;
    if (mode == 0) {
      const int32_t* order = static_cast<const int32_t*>(field);
      int32_t best_val = order[i];
      best = i;
      for (int k = 0; k < offs.n; ++k) {
        const int nx = x + offs.d[k][0], ny = y + offs.d[k][1],
                  nz = z + offs.d[k][2];
        if (nx < 0 || nx >= X || ny < 0 || ny >= Y || nz < 0 || nz >= Z)
          continue;
        const Id j = ((Id)nx * Y + ny) * Z + nz;
        const int32_t v = order[j];
        if (v > best_val) {
          best_val = v;
          best = j;
        }
      }
      if (self_mask != nullptr && self_mask[i]) best = i;
    } else {
      const uint8_t* mask = static_cast<const uint8_t*>(field);
      if (!mask[i]) {
        best = -1;
      } else {
        best = i;
        for (int k = 0; k < offs.n; ++k) {
          const int nx = x + offs.d[k][0], ny = y + offs.d[k][1],
                    nz = z + offs.d[k][2];
          if (nx < 0 || nx >= X || ny < 0 || ny >= Y || nz < 0 || nz >= Z)
            continue;
          const Id j = ((Id)nx * Y + ny) * Z + nz;
          if (mask[j] && j > best) best = j;
        }
        if (self_mask != nullptr && self_mask[i]) best = i;
      }
    }
    out[i] = best;
  }
}

template <typename Id>
__global__ void doubling_round(const Id* __restrict__ src, Id* __restrict__ dst,
                               Id n, Id tsize, int* __restrict__ changed) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int any = 0;
  for (int64_t ii = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       ii < (int64_t)n; ii += stride) {
    const Id i = (Id)ii;
    const Id d = src[i];
    const Id lo = i / tsize * tsize;
    Id nd = d;
    if (d >= lo && d - lo < tsize && d < n) nd = src[d];
    dst[i] = nd;
    any |= (nd != d);
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *changed = 1;
}

int grid_blocks(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename Id>
int run(const void* field, const uint8_t* self_mask, Id* out, Id* scratch,
        int* flag, int mode, int X, int Y, int Z, int block_x,
        const int* offsets, int n_offsets, int max_rounds,
        cudaStream_t stream, int* rounds_out) {
  *rounds_out = 0;
  if (n_offsets < 0 || n_offsets > kMaxOffsets) return cudaErrorInvalidValue;
  Offsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < n_offsets; ++k)
    for (int a = 0; a < 3; ++a) offs.d[k][a] = (int8_t)offsets[3 * k + a];
  const Id n = (Id)X * Y * Z;
  if (n == 0) return cudaSuccess;
  const int blocks = grid_blocks((int64_t)n);
  init_kernel<Id><<<blocks, kThreads, 0, stream>>>(field, self_mask, out, mode,
                                                  X, Y, Z, offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const Id tsize = (Id)block_x * Y * Z;
  Id* cur = out;
  Id* nxt = scratch;
  int rounds = 0, changed = 1;
  while (changed && rounds < max_rounds) {
    if ((err = cudaMemsetAsync(flag, 0, sizeof(int), stream)) != cudaSuccess)
      return err;
    doubling_round<Id><<<blocks, kThreads, 0, stream>>>(cur, nxt, n, tsize,
                                                       flag);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = cudaMemcpyAsync(&changed, flag, sizeof(int),
                               cudaMemcpyDeviceToHost, stream)) != cudaSuccess)
      return err;
    if ((err = cudaStreamSynchronize(stream)) != cudaSuccess) return err;
    Id* t = cur;
    cur = nxt;
    nxt = t;
    ++rounds;
  }
  if (cur != out) {
    err = cudaMemcpyAsync(out, cur, (size_t)n * sizeof(Id),
                          cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  *rounds_out = rounds;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// field: int32 order (mode 0) or bool/uint8 mask (mode 1), X*Y*Z row-major.
// self_mask: bool/uint8 X*Y*Z or NULL.  out, scratch: X*Y*Z ids.
// offsets: n_offsets (dx, dy, dz) triples.  Writes the round count to
// *rounds_out and returns a cudaError_t.
int fused_local_phase_i32(const void* field, const void* self_mask, void* out,
                          void* scratch, void* flag, int mode, int X, int Y,
                          int Z, int block_x, const int* offsets,
                          int n_offsets, int max_rounds, void* stream,
                          int* rounds_out) {
  return run<int32_t>(field, static_cast<const uint8_t*>(self_mask),
                      static_cast<int32_t*>(out),
                      static_cast<int32_t*>(scratch), static_cast<int*>(flag),
                      mode, X, Y, Z, block_x, offsets, n_offsets, max_rounds,
                      static_cast<cudaStream_t>(stream), rounds_out);
}

int fused_local_phase_i64(const void* field, const void* self_mask, void* out,
                          void* scratch, void* flag, int mode, int X, int Y,
                          int Z, int block_x, const int* offsets,
                          int n_offsets, int max_rounds, void* stream,
                          int* rounds_out) {
  return run<int64_t>(field, static_cast<const uint8_t*>(self_mask),
                      static_cast<int64_t*>(out),
                      static_cast<int64_t*>(scratch), static_cast<int*>(flag),
                      mode, X, Y, Z, block_x, offsets, n_offsets, max_rounds,
                      static_cast<cudaStream_t>(stream), rounds_out);
}

const char* fused_local_phase_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
