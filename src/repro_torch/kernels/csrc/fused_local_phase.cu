// Fused block-local phase of DPC for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_local_phase.py::fused_local_phase, the Pallas
// TPU kernel that the JAX package's Morse-Smale and connected-components
// queries run as their block-local phase.  It computes what that kernel
// computes, bit for bit: the pointers AND the round count for the tile
// (block_x, Y, Z).  The TPU kernel saturates each x-slab by synchronous
// pointer doubling; this one reaches the same fixpoint in one resolve pass
// and derives the doubling's round count from exact hop counts.
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
//   2. Bricks, one block each: bricks of at most 4096 voxels (up to 8
//      x-planes of the slab, as many y rows as fit, 32 z) tile every slab.
//      A block loads its brick's init pointers and keeps, in shared memory,
//      a 32-bit (brick-local next voxel, hops) pair per voxel and the
//      pointer's slab-local index.  In-place pointer jumping resolves the
//      chains that stay in the brick (a few rounds, one barrier each), and
//      the block writes one 8-byte word per voxel:
//        - kFinal for the last in-slab voxel of a chain (its pointer is
//          negative, leaves the slab, or is the voxel itself: a root);
//        - (slab-local index of the first voxel past the brick, hops) for a
//          chain that leaves the brick inside the slab; its bit in the
//          `open` bitmap is set;
//        - (the chain's last voxel, hops) marked kDone for a chain that
//          ends in the brick: the block writes its final pointer to `out`
//          and folds its hop count H (below) into a block max and one
//          atomicMax.
//   3. Resolve, one block per brick, last brick first: the block lists its
//      open voxels in shared memory and a thread per listed voxel chases
//      the words, adding hops, one hop per brick crossed, until a word is
//      final or kDone (then `out` there is final), with path halving: at
//      each step it rewrites the word of the voxel it stands on to skip the
//      next one, so chains shorten for every chase that comes later.  Every
//      stored pair is a true (voxel on the chain, exact hop distance) pair,
//      so races are harmless as long as each word is read and written
//      whole: relaxed device-scope 64-bit atomics, never two 4-byte halves.
//      No thread writes the word or the pointer of a voxel where chases
//      stop.  The thread writes out[i], stores (stop, hops) into its own
//      word and folds H(i) into the max.  cc pointers (and the steepest
//      chains of a ramp) point to larger ids, whose bricks go first.
//
// Why the round count stays exact.  With H(i) = 1 if p(i) is negative,
// outside the slab or a root, else 1 + H(p(i)), synchronous doubling leaves
// after k rounds the voxel min(2^k, H(i)) steps down i's chain.  Round k + 1
// changes a pointer iff 2^k < max H, so the TPU kernel runs
// rounds = 1 + ceil(log2(max H)) (1 when every H is 1, 0 for an empty
// field).  A chain in a slab has at most tsize hops, so this never exceeds
// the TPU kernel's cap, 1 + ceil(log2(tsize)), and no clamp is needed.  With D(i) the hops from i to the chain's last voxel L,
// H(i) is D(i) + 1 when L's pointer leaves the slab or is negative, D(i)
// when L is a root, and 1 when i is L.  The host reads max H, one 4-byte
// value a call, and computes rounds from it.
//
// Bound: device-memory bytes.  The least traffic is one read of the field
// (4 B/voxel order, 1 B/voxel mask), one write of the pointers (4 B/voxel
// int32) and one read of the optional self_mask (1 B/voxel).  This design
// moves about 8 + 16 + 12 B/voxel with int32 ids: init (read the field,
// write out), bricks (read out, write every word, write out where a chain
// ends in its brick), resolve (for the voxels whose chains leave their
// bricks: read on through the words, mostly in L2, write out and the own
// word).  Writing every word costs less than writing only the ones a chase
// can reach: partial 32-byte sectors cost device-memory reads.
//
// Port limit: a slab (min(block_x, X) * Y * Z voxels) must hold fewer than
// 2^31 voxels, so that its local indices and hops fit 31 bits; the wrapper
// raises ValueError above that.
//
// The kernel allocates nothing: the caller passes the output and a scratch
// buffer of fused_local_phase_scratch_bytes() (the words, 8 bytes a voxel;
// the bitmap, a bit a voxel; max H).  Every entry point runs on the given
// stream (init, a memset of max H, two launches), reads max H back once,
// and returns a cudaError_t (0 on success).

#include <cuda/atomic>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 512;   // a block: one brick
constexpr int kBrick = 4096;    // voxels of a brick, at most
constexpr int kPerThread = kBrick / kThreads;
constexpr uint32_t kFinal = 0xFFFFFFFFu;
constexpr uint32_t kDone = 0x80000000u;  // in the hops half: out is final
constexpr uint32_t kRoot = 0x80000000u;     // in a shared pointer: a root
constexpr uint32_t kOffSlab = 0xFFFFFFFFu;  // a negative or off-slab pointer
constexpr uint32_t kEnd = 0xFFFFu;          // in a shared pair: no next
constexpr int64_t kMaxSlab = int64_t{1} << 31;  // voxels a slab holds, excl.

using Word = unsigned long long;
using WordRef = cuda::atomic_ref<Word, cuda::thread_scope_device>;

__device__ __forceinline__ Word pack(uint32_t next, uint32_t hops) {
  return ((Word)hops << 32) | next;
}
__device__ __forceinline__ uint32_t next_of(Word w) { return (uint32_t)w; }
__device__ __forceinline__ uint32_t hops_of(Word w) {
  return (uint32_t)(w >> 32) & ~kDone;
}
__device__ __forceinline__ Word load(Word* w) {
  return WordRef(*w).load(cuda::std::memory_order_relaxed);
}
__device__ __forceinline__ void store(Word* w, Word v) {
  WordRef(*w).store(v, cuda::std::memory_order_relaxed);
}

// One block's max of h folded into *hmax; every thread of the block calls it.
__device__ __forceinline__ void fold_max(uint32_t h, unsigned* hmax) {
  __shared__ unsigned warp_max[kThreads / 32];
  h = __reduce_max_sync(0xffffffffu, h);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = h;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) h = max(h, warp_max[k]);
    // most blocks find a larger max already there and skip the atomic
    if (h > cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*hmax)
                .load(cuda::std::memory_order_relaxed))
      atomicMax(hmax, h);
  }
}

// n / d for 32-bit n by a multiply and a shift (Granlund and Montgomery's
// round-up method), d >= 1.
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (uint32_t)(((uint64_t)__umulhi(n, m) + n) >> s);
  }
};

FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((uint64_t{1} << s) < d) ++s;
  const uint64_t m = ((((uint64_t{1} << s) - d) << 32) / d + 1);
  return FastDiv{d, (uint32_t)m, s};
}

// Bricks of (bx, by, bz) voxels tile every slab of sx planes of the
// (X, Y, Z) grid; at the slab's and the grid's far faces a brick is cut,
// and its voxels past them are absent.  A brick's voxels are numbered
// brick-locally, z fastest, over the whole (bx, by, bz) box.
struct Bricks {
  int X, Y, Z, sx, bx, by, bz, nbx, nby, nbz;
  int bits;                // 32-bit words of one brick's bitmap
  uint32_t R;              // Y * Z
  FastDiv by_, bz_, R_, Z_;
};

Bricks make_bricks(int X, int Y, int Z, int sx) {
  Bricks b{};
  b.X = X, b.Y = Y, b.Z = Z, b.sx = sx;
  b.bz = Z < 32 ? Z : 32;
  b.bx = sx < 8 ? sx : 8;
  const int by = kBrick / (b.bx * b.bz);
  b.by = Y < by ? Y : by;
  b.nbx = (sx + b.bx - 1) / b.bx;   // a slab's bricks along x
  b.nby = (Y + b.by - 1) / b.by;
  b.nbz = (Z + b.bz - 1) / b.bz;
  b.bits = (b.bx * b.by * b.bz + 31) / 32;
  b.R = (uint32_t)Y * (uint32_t)Z;
  b.by_ = fast_div(b.by), b.bz_ = fast_div(b.bz), b.R_ = fast_div(b.R),
  b.Z_ = fast_div(Z);
  return b;
}

int64_t brick_count(const Bricks& b) {
  return (int64_t)((b.X + b.sx - 1) / b.sx) * b.nbx * b.nby * b.nbz;
}

// One brick: where it lies in its slab and which of its voxels are present.
struct Brick {
  int x0, y0, z0, ex, ey, ez;   // origin in the slab; extents present
  uint32_t corner, tsize;       // slab-local index of the origin; slab size
  int64_t lo;                   // flat id of the slab's first voxel

  __device__ Brick(const Bricks& b, int index) {
    const int zb = index % b.nbz;
    index /= b.nbz;
    const int yb = index % b.nby;
    index /= b.nby;
    const int slab_x = index / b.nbx * b.sx;
    const int planes = min(b.sx, b.X - slab_x);
    x0 = index % b.nbx * b.bx, y0 = yb * b.by, z0 = zb * b.bz;
    ex = min(b.bx, planes - x0), ey = min(b.by, b.Y - y0),
    ez = min(b.bz, b.Z - z0);
    corner = (uint32_t)x0 * b.R + (uint32_t)y0 * b.Z + z0;
    tsize = (uint32_t)planes * b.R;
    lo = (int64_t)slab_x * b.R;
  }

  // brick-local v -> slab-local index, or kFinal for an absent voxel
  __device__ __forceinline__ uint32_t slab_local(const Bricks& b,
                                                 int v) const {
    const uint32_t r = b.bz_.div(v), lz = v - r * b.bz;
    const uint32_t lx = b.by_.div(r), ly = r - lx * b.by;
    return (int)lx < ex && (int)ly < ey && (int)lz < ez
               ? corner + lx * b.R + ly * b.Z + lz
               : kFinal;
  }

  // slab-local index -> brick-local v, or kFinal outside the brick
  __device__ __forceinline__ uint32_t brick_local(const Bricks& b,
                                                  uint32_t l) const {
    const uint32_t x = b.R_.div(l), r = l - x * b.R;
    const uint32_t y = b.Z_.div(r);
    const uint32_t qx = x - x0, qy = y - y0, qz = r - y * b.Z - z0;
    return qx < (uint32_t)ex && qy < (uint32_t)ey && qz < (uint32_t)ez
               ? (qx * b.by + qy) * b.bz + qz
               : kFinal;
  }
};

// Chases a chain through the words `w` from voxel `from`, whose word `wc`
// is neither final nor done, to the first voxel whose word is, adding hops.
// Path halving: at each step the word of the voxel the chase stands on is
// rewritten to skip the next voxel, so the chain shortens for every later
// chase.  Each stored pair is a true (voxel down the chain, exact hop
// distance) pair, so concurrent chases only race to store true pairs.  At
// the end `from` gets the pair (the voxel the chase stopped at, its hops).
struct Chase {
  uint32_t stop, dist;   // the voxel the chase stopped at, hops to it
  Word word;             // its word
  // the chain's last voxel and the hops to it
  __device__ uint32_t last() const {
    return next_of(word) == kFinal ? stop : next_of(word);
  }
  __device__ uint32_t hops() const {
    return next_of(word) == kFinal ? dist : dist + hops_of(word);
  }
};

__device__ __forceinline__ bool ends(Word w) {
  return next_of(w) == kFinal || ((uint32_t)(w >> 32) & kDone);
}

__device__ __forceinline__ Chase chase(Word* w, uint32_t from, Word wc) {
  const uint32_t first = next_of(wc);
  uint32_t cur = from, dist = 0;  // dist: hops from `from` to cur
  Chase c;
  for (;;) {
    const uint32_t t = next_of(wc), hct = hops_of(wc);
    const Word wt = load(w + t);
    if (ends(wt)) {
      c = Chase{t, dist + hct, wt};
      break;
    }
    const uint32_t t2 = next_of(wt), hop = hct + hops_of(wt);
    store(w + cur, pack(t2, hop));
    dist += hop;
    cur = t2;
    wc = load(w + cur);
    if (ends(wc)) {
      c = Chase{cur, dist, wc};
      break;
    }
  }
  if (c.stop != first) store(w + from, pack(c.stop, c.dist));
  return c;
}

// Stage 1, one block per brick: the brick's init pointers go to shared
// memory as (brick-local next, hops) pairs, in-place pointer jumping
// resolves the chains that stay in the brick, and every voxel gets its
// word: kFinal for the last in-slab voxel of a chain, (slab-local voxel past
// the brick, hops) for a chain that leaves the brick inside the slab (its
// bit in `open` set), and (last voxel, hops) with kDone for a chain that
// ends in the brick, whose final pointer goes to `out` and whose H into
// *hmax here.
template <typename Id>
__global__ void __launch_bounds__(kThreads, 4)
    brick_words(Id* __restrict__ out, Word* __restrict__ words,
                uint32_t* __restrict__ open, Bricks b,
                unsigned* __restrict__ hmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  // (brick-local next voxel, hops) pairs of 16 + 16 bits
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  // the init pointer's slab-local index, with kRoot for a root; kOffSlab
  // if negative or off the slab
  uint32_t* sp = sw + kBrick;
  const Brick br(b, blockIdx.x);
  const Id lo = (Id)br.lo;
  const int B = b.bx * b.by * b.bz;
  // all of a thread's loads first, then the words
  uint32_t gl[kPerThread];
  Id p[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    gl[k] = v < B ? br.slab_local(b, v) : kFinal;
    p[k] = gl[k] != kFinal ? out[lo + gl[k]] : (Id)-1;
  }
  uint32_t active = 0, h = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v >= B) break;
    uint32_t w = kEnd;
    if (gl[k] != kFinal) {
      const bool in_slab = p[k] >= lo && p[k] - lo < (Id)br.tsize;
      const uint32_t pl = (uint32_t)(p[k] - lo);
      sp[v] = !in_slab ? kOffSlab : pl == gl[k] ? pl | kRoot : pl;
      const uint32_t q =
          in_slab && pl != gl[k] ? br.brick_local(b, pl) : kFinal;
      if (q != kFinal) {
        w = q | 1u << 16;
        active |= 1u << k;
      }
    }
    sw[v] = w;
  }
  __syncthreads();
  int changed;
  do {
    changed = 0;
    for (int k = 0; k < kPerThread; ++k) {
      if (!(active >> k & 1)) continue;
      cuda::atomic_ref<uint32_t, cuda::thread_scope_block> at(
          sw[threadIdx.x + k * kThreads]);
      const uint32_t w = at.load(cuda::std::memory_order_relaxed);
      const uint32_t w2 =
          cuda::atomic_ref<uint32_t, cuda::thread_scope_block>(sw[w & kEnd])
              .load(cuda::std::memory_order_relaxed);
      if ((w2 & kEnd) == kEnd) {
        active &= ~(1u << k);   // points at the last voxel in the brick
        continue;
      }
      // hops add in the high half: a brick's chains have < 2^16 hops
      at.store((w2 & kEnd) | ((w & ~kEnd) + (w2 & ~kEnd)),
               cuda::std::memory_order_relaxed);
      changed = 1;
    }
  } while (__syncthreads_or(changed));
  uint32_t* bits = open + (int64_t)blockIdx.x * b.bits;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    bool leaves = false;
    if (gl[k] != kFinal) {
      const uint32_t w = sw[v];
      const bool moved = (w & kEnd) != kEnd;
      const int e = moved ? (int)(w & kEnd) : v;   // the last voxel here
      const uint32_t d = w >> 16;
      const uint32_t pe = sp[e];
      Word word;
      if (pe < kRoot) {
        word = pack(pe, d + 1);             // leaves the brick in the slab
        leaves = true;
      } else if (!moved) {
        word = pack(kFinal, 0);             // the chain's last voxel
        h = max(h, 1u);
      } else {                              // ends in the brick
        const bool root = pe != kOffSlab;
        const uint32_t ge = root ? pe - kRoot : br.slab_local(b, e);
        out[lo + gl[k]] = root ? lo + ge : out[lo + ge];
        word = pack(ge, d | kDone);
        h = max(h, root ? d : d + 1);
      }
      words[lo + gl[k]] = word;
    }
    // a warp's 32 voxels are 32 consecutive bits
    const uint32_t ballot = __ballot_sync(0xffffffffu, leaves);
    if (threadIdx.x % 32 == 0 && v < B) bits[v / 32] = ballot;
  }
  fold_max(h, hmax);
}

// Stage 2, one block per brick, last brick first: the block lists the
// brick's open voxels (bits of `open`) in shared memory, and a thread per
// listed voxel chases the words, one hop per brick crossed, to the chain's
// last voxel or to a voxel that stage 1 resolved (kDone), whose pointer in
// `out` is then final.
template <typename Id>
__global__ void __launch_bounds__(kThreads)
    resolve(Id* out, Word* words, const uint32_t* __restrict__ open,
            Bricks b, unsigned* hmax) {
  __shared__ uint16_t list[kBrick];
  __shared__ int listed;
  const int index = gridDim.x - 1 - blockIdx.x;
  const uint32_t* bits = open + (int64_t)index * b.bits;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < b.bits; j += kThreads) {
    uint32_t word = bits[j];
    int at = word ? atomicAdd(&listed, __popc(word)) : 0;
    for (; word; word &= word - 1) list[at++] = j * 32 + __ffs(word) - 1;
  }
  __syncthreads();
  const Brick br(b, index);
  const Id lo = (Id)br.lo;
  Word* w = words + br.lo;
  uint32_t h = 0;
  for (int j = threadIdx.x; j < listed; j += kThreads) {
    const uint32_t li = br.slab_local(b, list[j]);
    const Chase c = chase(w, li, load(w + li));
    const Id f = out[lo + c.stop];   // final there: no thread writes it
    out[lo + li] = f;
    h = max(h, f == lo + c.last() ? c.hops() : c.hops() + 1);
  }
  fold_max(h, hmax);
}

// 1 + ceil(log2(h)) for h >= 1: the doubling rounds of a longest chain of
// h hops, the last of them the round that changes nothing.
int rounds_for(unsigned h) {
  int r = 1;
  for (unsigned reach = 1; reach < h; reach *= 2) ++r;
  return r;
}

// The caller's scratch: the words (8 bytes a voxel), the bitmap of open
// voxels (a bit a voxel of every brick's box) and max H.
struct Scratch {
  Word* words;
  uint32_t* open;
  unsigned* hmax;
};

Scratch carve(void* scratch, int64_t n, const Bricks& b) {
  Word* words = static_cast<Word*>(scratch);
  uint32_t* open = reinterpret_cast<uint32_t*>(words + n);
  return Scratch{words, open, open + brick_count(b) * b.bits};
}

int64_t scratch_bytes(int64_t n, const Bricks& b) {
  const int64_t bytes = n * (int64_t)sizeof(Word) +
                        (brick_count(b) * b.bits + 1) * sizeof(uint32_t);
  return (bytes + 7) / 8 * 8;
}

template <typename Id>
int run(const void* field, const uint8_t* self_mask, Id* out, void* scratch,
        int mode, int X, int Y, int Z, int block_x, const int* offsets,
        int n_offsets, cudaStream_t stream, int* rounds_out) {
  *rounds_out = 0;
  if (!stencil::offsets_match(n_offsets, offsets) || (mode != 0 && mode != 1)
      || block_x < 1)
    return cudaErrorInvalidValue;
  const int64_t n = (int64_t)X * Y * Z;
  if (n == 0) return cudaSuccess;
  // a slab past X is the same slab as one of X planes
  const int sx = block_x < X ? block_x : X;
  if ((int64_t)sx * Y * Z >= kMaxSlab) return cudaErrorInvalidValue;
  const Bricks b = make_bricks(X, Y, Z, sx);
  const int64_t n_bricks = brick_count(b);
  if (n_bricks >= kMaxSlab) return cudaErrorInvalidValue;
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
  constexpr int smem = kBrick * 2 * sizeof(uint32_t);
  if ((err = cudaFuncSetAttribute(brick_words<Id>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  brick_words<Id><<<(unsigned)n_bricks, kThreads, smem, stream>>>(
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

// Bytes of the scratch buffer a call on an (X, Y, Z) field with block_x
// takes (8-byte aligned).  The entry points take a slab of fewer than 2^31
// voxels only; the wrapper checks that before it asks for the size.
int64_t fused_local_phase_scratch_bytes(int X, int Y, int Z, int block_x) {
  if (X < 1 || Y < 1 || Z < 1 || block_x < 1) return 8;
  const int sx = block_x < X ? block_x : X;
  return scratch_bytes((int64_t)X * Y * Z, make_bricks(X, Y, Z, sx));
}

// field: int32 order (mode 0) or bool/uint8 mask (mode 1), X*Y*Z row-major.
// self_mask: bool/uint8 X*Y*Z or NULL.  out: X*Y*Z ids.  scratch:
// fused_local_phase_scratch_bytes(X, Y, Z, block_x) bytes.  offsets:
// n_offsets (dx, dy, dz) triples, which must be stencil.cuh's table for
// connectivity n_offsets (6, 14, 18 or 26).  Writes the round count to
// *rounds_out and returns a cudaError_t.
int fused_local_phase_i32(const void* field, const void* self_mask, void* out,
                          void* scratch, int mode, int X, int Y, int Z,
                          int block_x, const int* offsets, int n_offsets,
                          void* stream, int* rounds_out) {
  return run<int32_t>(field, static_cast<const uint8_t*>(self_mask),
                      static_cast<int32_t*>(out), scratch, mode, X, Y, Z,
                      block_x, offsets, n_offsets,
                      static_cast<cudaStream_t>(stream), rounds_out);
}

int fused_local_phase_i64(const void* field, const void* self_mask, void* out,
                          void* scratch, int mode, int X, int Y, int Z,
                          int block_x, const int* offsets, int n_offsets,
                          void* stream, int* rounds_out) {
  return run<int64_t>(field, static_cast<const uint8_t*>(self_mask),
                      static_cast<int64_t*>(out), scratch, mode, X, Y, Z,
                      block_x, offsets, n_offsets,
                      static_cast<cudaStream_t>(stream), rounds_out);
}

const char* fused_local_phase_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
