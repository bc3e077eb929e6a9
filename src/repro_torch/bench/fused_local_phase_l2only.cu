// A/B variant of kernels/csrc/fused_local_phase.cu without its brick stage,
// built only by fused_local_phase_ab.py to measure what that stage buys.
//
// The init, the chase kernel (`resolve`) and the round rule are the shipped
// file's own, included below.  Only the brick pass is replaced: a pass that
// writes every voxel's word straight from its init pointer -- (slab-local
// index of p(i), 1 hop) with its bit in `open` set, or kFinal for the last
// in-slab voxel of a chain -- so the chase walks the whole chain through the
// words in L2 and device memory, one hop per voxel, with path halving.

#include "../kernels/csrc/fused_local_phase.cu"

namespace {

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    plain_words(const Id* __restrict__ out, Word* __restrict__ words,
                uint32_t* __restrict__ open, Bricks b,
                unsigned* __restrict__ hmax) {
  const Brick br(b, blockIdx.x);
  const Id lo = (Id)br.lo;
  const int B = b.bx * b.by * b.bz;
  uint32_t* bits = open + (int64_t)blockIdx.x * b.bits;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    const uint32_t gl = v < B ? br.slab_local(b, v) : kFinal;
    bool leaves = false;
    if (gl != kFinal) {
      const Id p = out[lo + gl];
      const uint32_t pl = (uint32_t)(p - lo);
      leaves = p >= lo && p - lo < (Id)br.tsize && pl != gl;
      words[lo + gl] = leaves ? pack(pl, 1) : pack(kFinal, 0);
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, leaves);
    if (threadIdx.x % 32 == 0 && v < B) bits[v / 32] = ballot;
  }
  // a chain's last voxel has H = 1; the chase folds every other voxel's H
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicMax(hmax, 1u);
}

// `run` of the shipped file with plain_words in place of brick_words.
template <typename Id>
int run_l2only(const void* field, const uint8_t* self_mask, Id* out,
               void* scratch, int mode, int X, int Y, int Z, int block_x,
               const int* offsets, int n_offsets, cudaStream_t stream,
               int* rounds_out) {
  *rounds_out = 0;
  if (!stencil::offsets_match(n_offsets, offsets) || (mode != 0 && mode != 1)
      || block_x < 1)
    return cudaErrorInvalidValue;
  const int64_t n = (int64_t)X * Y * Z;
  if (n == 0) return cudaSuccess;
  const int sx = block_x < X ? block_x : X;
  if ((int64_t)sx * Y * Z >= kMaxSlab) return cudaErrorInvalidValue;
  const Bricks b = make_bricks(X, Y, Z, sx);
  const int64_t n_bricks = brick_count(b);
  const Scratch s = carve(scratch, n, b);
  cudaError_t err =
      mode == 0 ? stencil::launch_init<stencil::kSteepest, Id>(
                      n_offsets, field, self_mask, out, X, Y, Z, stream)
                : stencil::launch_init<stencil::kMaskedMax, Id>(
                      n_offsets, field, self_mask, out, X, Y, Z, stream);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(s.hmax, 0, sizeof(unsigned), stream)) !=
      cudaSuccess)
    return err;
  plain_words<Id><<<(unsigned)n_bricks, kThreads, 0, stream>>>(
      out, s.words, s.open, b, s.hmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  resolve<Id><<<(unsigned)n_bricks, kThreads, 0, stream>>>(
      out, s.words, s.open, b, s.hmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  unsigned h = 0;
  if ((err = cudaMemcpyAsync(&h, s.hmax, sizeof(h), cudaMemcpyDeviceToHost,
                             stream)) != cudaSuccess)
    return err;
  if ((err = cudaStreamSynchronize(stream)) != cudaSuccess) return err;
  *rounds_out = rounds_for(h);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The shipped entry points' arguments and scratch.
int fused_local_phase_l2only_i32(const void* field, const void* self_mask,
                                 void* out, void* scratch, int mode, int X,
                                 int Y, int Z, int block_x,
                                 const int* offsets, int n_offsets,
                                 void* stream, int* rounds_out) {
  return run_l2only<int32_t>(field, static_cast<const uint8_t*>(self_mask),
                             static_cast<int32_t*>(out), scratch, mode, X, Y,
                             Z, block_x, offsets, n_offsets,
                             static_cast<cudaStream_t>(stream), rounds_out);
}

int fused_local_phase_l2only_i64(const void* field, const void* self_mask,
                                 void* out, void* scratch, int mode, int X,
                                 int Y, int Z, int block_x,
                                 const int* offsets, int n_offsets,
                                 void* stream, int* rounds_out) {
  return run_l2only<int64_t>(field, static_cast<const uint8_t*>(self_mask),
                             static_cast<int64_t*>(out), scratch, mode, X, Y,
                             Z, block_x, offsets, n_offsets,
                             static_cast<cudaStream_t>(stream), rounds_out);
}

}  // extern "C"
