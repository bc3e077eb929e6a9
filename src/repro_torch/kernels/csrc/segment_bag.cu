// Sum EmbeddingBag (gather + per-bag sum) for Hopper (sm_90a).
//
// Replaces repro/kernels/segment_bag.py::segment_bag, the Pallas TPU kernel
// that sums, for each bag b of a (B, L) id array, the table rows of its ids.
// An id contributes its row only if it lies in [0, V): -1 pads, other
// negative ids and ids >= V (int64 ids past 2^31 too) fall in no vocab tile
// of the TPU kernel and add nothing; this kernel reads no row outside the
// table.  Sums accumulate in fp32 and are cast to the table's dtype once
// (round to nearest even for bf16, as torch's .to(torch.bfloat16) rounds).
//
// The TPU kernel sweeps the vocabulary in tiles because a TPU cannot chase
// rows; a GPU gathers rows directly.  What bounds the gather on this card is
// not the bytes of the distinct rows (the bound below) but the row each
// reference reads again: from L2 where the row still is, at the rate L2
// feeds the SMs, else from device memory at a random address.  So the
// design spends as few instructions a row as it can, keeps many rows in
// flight, and keeps L2 for the table:
//
//   * A row is read by a group of lanes in VEC-byte loads, VEC = 16 where
//     the row bytes and the table's and output's addresses allow it (8, 4,
//     or one element otherwise: any D, any base, one kernel).  At D = 32 a
//     group is 8 lanes (fp32) or 4 (bf16), so one warp instruction fetches
//     4 or 8 rows.  Rows wider than 32 chunks take more passes.
//   * Each group gathers kRows ids, 16 fp32 or 8 bf16 (16-byte loads where
//     the id array allows it), and issues their row loads before the first
//     add, so a warp has 64 rows in flight at D = 32.  A bag gets the
//     fewest groups that cover its L ids in one step (at L = 16: one fp32
//     group, two bf16, so a warp takes four bags); the groups of a bag sum
//     their fp32 partials with shuffles and the first group stores the row
//     of sums in VEC-byte stores.
//   * L2 policy (Hopper's createpolicy + ld/st .L2::cache_hint): table rows
//     are loaded evict_last, the ids and the output are streamed evict_first,
//     so that they do not push rows that other bags will read out of L2.
//
// The summation order (groups over contiguous runs of ids, then a shuffle
// tree) differs from the TPU kernel's (per vocab tile, then across tiles)
// and from the plain version's: the tests compare within 1e-5 for fp32 and
// 3e-2 for bf16.
//
// Bound: device-memory bytes: the ids once, every distinct table row the
// ids name once, and the (B, D) output once.  This design reads a row once
// per reference (from L2 when it is still there).
//
// The kernel allocates nothing and uses no shared memory; every entry point
// launches on the given stream and returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segment_bag {

constexpr int kThreads = 256;  // 8 warps a block
// ids a group gathers before its adds: 64 rows in flight a warp at D = 32
template <typename T>
constexpr int kRows = sizeof(T) == 4 ? 16 : 8;
constexpr unsigned kFull = 0xffffffffu;

// VEC bytes of a row (or of ids) as 32-bit words; VEC = 2 uses the low half
// of one word.
template <int VEC>
struct Words {
  uint32_t v[VEC >= 4 ? VEC / 4 : 1];
};

// L2 eviction policies: evict_last for table rows and evict_first for the
// streams where `hint`, evict_normal (the default priority) for both else.
template <bool hint>
__device__ __forceinline__ uint64_t row_policy() {
  uint64_t p;
  if constexpr (hint)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(p));
  return p;
}
template <bool hint>
__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t p;
  if constexpr (hint)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(p));
  return p;
}

// VEC bytes at p (VEC-aligned) through the read-only path, not kept in L1,
// under L2 policy `pol`; zeros where !ok (no load is issued).
template <int VEC>
__device__ __forceinline__ Words<VEC> load(const void* p, bool ok,
                                           uint64_t pol) {
  Words<VEC> w;
  if constexpr (VEC == 16) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
        "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\tmov.b32 %2, 0;\n\t"
        "mov.b32 %3, 0;\n\t"
        "@p ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
        "{%0, %1, %2, %3}, [%4], %6;\n\t}"
        : "=r"(w.v[0]), "=r"(w.v[1]), "=r"(w.v[2]), "=r"(w.v[3])
        : "l"(p), "r"((int)ok), "l"(pol));
  } else if constexpr (VEC == 8) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
        "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\t"
        "@p ld.global.nc.L1::no_allocate.L2::cache_hint.v2.u32 "
        "{%0, %1}, [%2], %4;\n\t}"
        : "=r"(w.v[0]), "=r"(w.v[1])
        : "l"(p), "r"((int)ok), "l"(pol));
  } else if constexpr (VEC == 4) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "mov.b32 %0, 0;\n\t"
        "@p ld.global.nc.L1::no_allocate.L2::cache_hint.u32 "
        "%0, [%1], %3;\n\t}"
        : "=r"(w.v[0])
        : "l"(p), "r"((int)ok), "l"(pol));
  } else {
    static_assert(VEC == 2, "VEC is 16, 8, 4 or 2 bytes");
    unsigned short h;
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "mov.b16 %0, 0;\n\t"
        "@p ld.global.nc.L1::no_allocate.L2::cache_hint.u16 "
        "%0, [%1], %3;\n\t}"
        : "=h"(h)
        : "l"(p), "r"((int)ok), "l"(pol));
    w.v[0] = h;
  }
  return w;
}

// VEC bytes of w to p (VEC-aligned) under L2 policy `pol`.
template <int VEC>
__device__ __forceinline__ void store(void* p, const Words<VEC>& w,
                                      uint64_t pol) {
  if constexpr (VEC == 16)
    asm volatile(
        "st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(
            p),
        "r"(w.v[0]), "r"(w.v[1]), "r"(w.v[2]), "r"(w.v[3]), "l"(pol)
        : "memory");
  else if constexpr (VEC == 8)
    asm volatile("st.global.L2::cache_hint.v2.u32 [%0], {%1, %2}, %3;" ::"l"(
                     p),
                 "r"(w.v[0]), "r"(w.v[1]), "l"(pol)
                 : "memory");
  else if constexpr (VEC == 4)
    asm volatile("st.global.L2::cache_hint.u32 [%0], %1, %2;" ::"l"(p),
                 "r"(w.v[0]), "l"(pol)
                 : "memory");
  else
    asm volatile("st.global.L2::cache_hint.u16 [%0], %1, %2;" ::"l"(p),
                 "h"((unsigned short)w.v[0]), "l"(pol)
                 : "memory");
}

// Element e of a chunk as fp32, and back.
template <typename T, int VEC>
__device__ __forceinline__ float element(const Words<VEC>& w, int e) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w.v[e]);
  else
    return __uint_as_float(e & 1 ? w.v[e / 2] & 0xffff0000u
                                 : w.v[e / 2] << 16);
}
template <typename T, int VEC>
__device__ __forceinline__ Words<VEC> pack(const float (&acc)[VEC / sizeof(T)]) {
  Words<VEC> w;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VEC / 4; ++e) w.v[e] = __float_as_uint(acc[e]);
  } else if constexpr (VEC == 2) {
    w.v[0] = __bfloat16_as_ushort(__float2bfloat16(acc[0]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      w.v[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i])) |
               (uint32_t)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i + 1]))
                   << 16;
  }
  return w;
}

// ids[l0 .. l0 + ROWS) of a bag (-1 past L).  Where `vec` (the id array's
// base and L * sizeof(I) are multiples of the piece size), in pieces of
// min(16, ROWS * sizeof(I)) bytes, each wholly inside the bag or wholly past
// it; else id by id.
template <typename I, int ROWS>
__device__ __forceinline__ void load_ids(const I* bag_ids, int l0, int L,
                                         bool vec, uint64_t pol,
                                         int64_t (&id)[ROWS]) {
  constexpr int kPiece = ROWS * (int)sizeof(I) < 16 ? ROWS * sizeof(I) : 16;
  constexpr int kPer = kPiece / sizeof(I);
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS / kPer; ++k) {
      const int l = l0 + k * kPer;
      const Words<kPiece> w = load<kPiece>(bag_ids + l, l < L, pol);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int64_t x;
        if constexpr (sizeof(I) == 4)
          x = (int32_t)w.v[j];
        else
          x = (int64_t)((uint64_t)w.v[2 * j + 1] << 32 | w.v[2 * j]);
        id[k * kPer + j] = l < L ? x : -1;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool in = l0 + r < L;
      const Words<sizeof(I)> w = load<sizeof(I)>(bag_ids + (in ? l0 + r : 0),
                                                 in, pol);
      int64_t x;
      if constexpr (sizeof(I) == 4)
        x = (int32_t)w.v[0];
      else
        x = (int64_t)((uint64_t)w.v[1] << 32 | w.v[0]);
      id[r] = in ? x : -1;
    }
  }
}

// One warp takes 1 << wshift bags (wshift = 5 - gshift - qshift): lanes in
// groups of 1 << gshift read a row's chunks, 1 << qshift groups share a bag.
// The port launches ROWS = kRows<T> with the L2 policies on (HINT); other
// ROWS and HINT = false are built only by bench/segment_bag_variants.cu.
template <typename T, typename I, int VEC, int ROWS, bool HINT>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ table, const I* __restrict__ ids,
               T* __restrict__ out, int64_t V, int chunks, int gshift,
               int qshift, int64_t B, int L, bool ids_vec) {
  constexpr int E = VEC / sizeof(T);  // elements a chunk
  const int lane = threadIdx.x & 31;
  const int wshift = 5 - gshift - qshift;
  const int64_t bag0 =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) << wshift;
  if (bag0 >= B) return;  // whole warps leave together
  const int group = lane >> gshift;
  const int col = lane & ((1 << gshift) - 1);
  const int q = group & ((1 << qshift) - 1);
  const int64_t bag = bag0 + (group >> qshift);
  const bool live = bag < B;
  const I* bag_ids = ids + (live ? bag : 0) * L;
  const int64_t row_bytes = (int64_t)chunks * VEC;
  const uint64_t rows_pol = row_policy<HINT>();
  const uint64_t stream_pol = stream_policy<HINT>();
  const char* base = reinterpret_cast<const char*>(table);
  for (int c0 = 0; c0 < chunks; c0 += 1 << gshift) {  // warp-uniform
    const int c = c0 + col;
    const bool in_row = live && c < chunks;
    float acc[E] = {};
    for (int l0 = q * ROWS; live && l0 < L; l0 += ROWS << qshift) {
      int64_t id[ROWS];
      load_ids<I, ROWS>(bag_ids, l0, L, ids_vec, stream_pol, id);
      Words<VEC> w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {  // every row in flight, then the adds
        const bool ok = in_row && id[r] >= 0 && id[r] < V;
        w[r] = load<VEC>(base + (ok ? id[r] : 0) * row_bytes + (int64_t)c * VEC, ok,
                         rows_pol);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += element<T, VEC>(w[r], e);
    }
    for (int s = 1 << gshift; s < 1 << (gshift + qshift); s <<= 1)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], s);
    if (q == 0 && in_row)
      store<VEC>(reinterpret_cast<char*>(out) + bag * row_bytes + (int64_t)c * VEC,
                 pack<T, VEC>(acc), stream_pol);
  }
}

// The launch shape of one call.
struct Plan {
  int vec;      // bytes a lane loads of a row at once
  int chunks;   // row bytes / vec
  int gshift;   // lanes a row: 1 << gshift
  int qshift;   // groups a bag: 1 << qshift
  bool ids_vec; // ids in pieces of min(16, rows * sizeof(I)) bytes
  int64_t blocks;
};

inline int log2_ceil(int64_t x) {
  int s = 0;
  while (((int64_t)1 << s) < x) ++s;
  return s;
}

// Blocks of kThreads for B bags, a warp taking 1 << (5 - gshift - qshift).
inline int64_t blocks(int64_t B, int gshift, int qshift) {
  const int bags = 5 - gshift - qshift;
  const int64_t warps = (B + ((int64_t)1 << bags) - 1) >> bags;
  return (warps + kThreads / 32 - 1) / (kThreads / 32);
}

// The widest row load (16 bytes, else 8, 4 or one element) that the row
// bytes and the table's and output's addresses allow, and the fewest groups
// a bag that cover its L ids in one step of `rows` ids a group.
inline Plan plan(const void* table, const void* ids, const void* out,
                 int elem, int id_size, int D, int64_t B, int L, int rows) {
  Plan p;
  const int64_t row = (int64_t)D * elem;
  p.vec = 16;
  while (p.vec > elem &&
         (row % p.vec || (uintptr_t)table % p.vec || (uintptr_t)out % p.vec))
    p.vec >>= 1;
  p.chunks = (int)(row / p.vec);
  p.gshift = log2_ceil(p.chunks) < 5 ? log2_ceil(p.chunks) : 5;
  const int need = log2_ceil(((int64_t)L + rows - 1) / rows);
  p.qshift = need < 5 - p.gshift ? need : 5 - p.gshift;
  const int piece = rows * id_size < 16 ? rows * id_size : 16;
  p.ids_vec = (uintptr_t)ids % piece == 0 && ((int64_t)L * id_size) % piece == 0;
  p.blocks = blocks(B, p.gshift, p.qshift);
  return p;
}

template <typename T, typename I>
int run(const void* table, const void* ids, void* out, int64_t V, int D,
        int64_t B, int L, cudaStream_t stream) {
  if (V < 0 || D < 0 || B < 0 || L < 0) return cudaErrorInvalidValue;
  if (B == 0 || D == 0) return cudaSuccess;
  if ((uintptr_t)table % sizeof(T) || (uintptr_t)out % sizeof(T) ||
      (uintptr_t)ids % sizeof(I))
    return cudaErrorMisalignedAddress;
  const Plan p = plan(table, ids, out, sizeof(T), sizeof(I), D, B, L,
                      kRows<T>);
  if (p.blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const T* t = static_cast<const T*>(table);
  const I* i = static_cast<const I*>(ids);
  T* o = static_cast<T*>(out);
#define SEGMENT_BAG_LAUNCH(VEC)                                              \
  bag_kernel<T, I, VEC, kRows<T>, true><<<(unsigned)p.blocks, kThreads, 0,   \
                                          stream>>>(t, i, o, V, p.chunks,    \
                                                    p.gshift, p.qshift, B, L, \
                                                    p.ids_vec)
  switch (p.vec) {
    case 16: SEGMENT_BAG_LAUNCH(16); break;
    case 8: SEGMENT_BAG_LAUNCH(8); break;
    case 4: SEGMENT_BAG_LAUNCH(4); break;
    default:
      if constexpr (sizeof(T) == 2) SEGMENT_BAG_LAUNCH(2);
      break;
  }
#undef SEGMENT_BAG_LAUNCH
  return cudaGetLastError();
}

}  // namespace segment_bag

extern "C" {

// table: V*D rows of float32 or bfloat16; ids: B*L int32 or int64;
// out: B*D of the table's type.  Returns a cudaError_t.
int segment_bag_f32_i32(const void* table, const void* ids, void* out,
                        int64_t V, int D, int64_t B, int L, void* stream) {
  return segment_bag::run<float, int32_t>(table, ids, out, V, D, B, L,
                                          static_cast<cudaStream_t>(stream));
}
int segment_bag_f32_i64(const void* table, const void* ids, void* out,
                        int64_t V, int D, int64_t B, int L, void* stream) {
  return segment_bag::run<float, int64_t>(table, ids, out, V, D, B, L,
                                          static_cast<cudaStream_t>(stream));
}
int segment_bag_bf16_i32(const void* table, const void* ids, void* out,
                         int64_t V, int D, int64_t B, int L, void* stream) {
  return segment_bag::run<__nv_bfloat16, int32_t>(
      table, ids, out, V, D, B, L, static_cast<cudaStream_t>(stream));
}
int segment_bag_bf16_i64(const void* table, const void* ids, void* out,
                         int64_t V, int D, int64_t B, int L, void* stream) {
  return segment_bag::run<__nv_bfloat16, int64_t>(
      table, ids, out, V, D, B, L, static_cast<cudaStream_t>(stream));
}

const char* segment_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
