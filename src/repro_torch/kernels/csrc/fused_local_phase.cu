// Fused block-local phase of DPC for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_local_phase.py::fused_local_phase, the Pallas
// TPU kernel that the JAX package's Morse-Smale and connected-components
// queries run as their block-local phase.  It computes what that kernel
// computes, bit for bit: the pointers AND the round count for the tile
// (block_x, Y, Z).
//
//   1. Init: stencil.cuh's global stencil, one thread per voxel, templated
//      on the connectivity.  mode 0 (manifold): the steepest neighbor --
//      self first, then the offsets in the order of
//      repro_torch/core/steepest.py, a candidate replacing the best only if
//      strictly greater (jnp.argmax's first-max-wins).  mode 1 (cc): the
//      largest masked neighbor id including self, -1 for unmasked voxels.
//      The optional self_mask forces (masked) voxels to point at themselves.
//      The TPU kernel reads the x-neighbours across slab boundaries as halo
//      planes, so the init is a plain global stencil; out-of-grid neighbours
//      are skipped (the TPU's inert fill never wins).  A ragged X needs no
//      padding: a short last tile gives the pointers and rounds of the TPU
//      kernel's pinned pad rows.  steepest_neighbor.cu runs the same init.
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

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

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
  if (!stencil::offsets_match(n_offsets, offsets) || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  const Id n = (Id)X * Y * Z;
  if (n == 0) return cudaSuccess;
  cudaError_t err =
      mode == 0 ? stencil::launch_init<stencil::kSteepest, Id>(
                      n_offsets, field, self_mask, out, X, Y, Z, stream)
                : stencil::launch_init<stencil::kMaskedMax, Id>(
                      n_offsets, field, self_mask, out, X, Y, Z, stream);
  if (err != cudaSuccess) return err;
  const int blocks = grid_blocks((int64_t)n);

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
// offsets: n_offsets (dx, dy, dz) triples, which must be stencil.cuh's
// table for connectivity n_offsets (6, 14, 18 or 26).  Writes the round count to
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
