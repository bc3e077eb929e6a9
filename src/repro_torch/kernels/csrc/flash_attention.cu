// Forward attention with an online softmax for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel: q (B, H, Sq, D), k and v (B, Hkv, Sk, D) with H a multiple of
// Hkv, output (B, H, Sq, D) in q's dtype.  What it computes, as the TPU
// kernel does:
//   * scores q.k scaled by 1/sqrt(D) (the wrapper passes the scale rounded
//     to fp32), in fp32; m, l and the accumulator are fp32;
//   * GQA by index: query head h reads kv head h / (H / Hkv), no copy;
//   * causal mask q_pos + (Sk - Sq) >= k_pos, with masked scores set to
//     -1e30 and m starting at -1e30, not -inf: a query row whose keys are
//     all masked (causal with Sk < Sq) then weighs every key equally and
//     gets the mean of V, where the jnp references give NaN;
//   * output acc / max(l, 1e-30), cast to q's dtype (round to nearest even
//     for bf16).
// Under the causal mask a CTA stops at its last row's last visible key: the
// skipped tiles would add exp(-1e30 - m) = 0 to l and to the accumulator
// and leave m as it is.  A CTA that holds a fully masked row walks every
// key, as that row must average all of V.  Keys past Sk add nothing (p = 0,
// not -1e30).  Causal CTAs are issued longest first (reversed q-tile order).
//
// Three kernels:
//
// flash_tc, bf16 with D <= 256, on the tensor cores (FA2-style), templated
// on the padded head dim Dp = 64, 128 or 256.  A CTA of 4 warps holds the
// query rows of one (b, h): 32 a warp at Dp = 64 (each K and V fragment
// feeds two m16 row tiles, halving shared-memory reads per flop), 16 above,
// where O's registers allow no more.  It walks the keys in tiles of 64
// (Dp <= 128) or 32 (Dp = 256).  Q is copied once into shared memory; K
// and V tiles go through a two-stage cp.async ring (16-byte copies; element
// loads where a row is not 16-byte aligned, D % 8 != 0).  Rows are padded
// by 8 bf16 so that ldmatrix is free of bank conflicts; columns past D and
// rows past Sk are zero.  S = Q K^T is mma.sync m16n8k16 (bf16 in, fp32
// out) from ldmatrix fragments; the scale and log2(e) multiply the fp32
// scores, then exp2 on the SFU.  The mask and the Sk test run only on tiles
// that cross the diagonal or pass Sk.  The row max and sum reduce across
// the 4 lanes of a quad.  P stays in registers as the A operand of O += P V
// (the m16n8 C fragment of S has the layout of the m16n8k16 A fragment),
// split into two bf16 parts, P_hi + P_lo, each its own mma: P_hi alone
// (2^-9 relative) moves the output of a row that sees a few keys by more
// than one bf16 ulp of the fp32-P result, the pair (~2^-17) does not.  V
// comes through ldmatrix.trans, O stays fp32 in registers; l sums the fp32
// p.  The epilogue goes through shared memory to 16-byte stores.
//
// flash_f32tc, f32 with D <= 128, Dp = 64 or 128, in flash_tc's frame
// (4 warps, 32 query rows a warp at Dp = 64 and 16 at 128, key tiles of 64,
// a two-stage cp.async ring; fp32 rows padded to Dp + 4 words, which keeps
// its 16-byte Q and K reads and 4-byte V reads free of bank conflicts).
// q is scaled in fp32 in shared memory, as the reference scales it.
// QK^T runs on the CUDA cores: each lane holds S's mma C fragment (rows g,
// g + 8; keys 2tq, 2tq + 1 of each 8) and sums every score as one fma chain
// over d = 0, 1, ..., the order of the reference's fp32 product.  The tensor
// cores cannot keep that order (an mma sums 8 products at once), and at
// scores of hundreds the reference's own fp32 sums are already past 2e-5
// of the exact result, so a kernel in any other order misses 2e-5 of the
// reference (tests/test_torch_kernels.py models it; on the card,
// src/repro_torch/bench/flash_f32_ab.py finds the reference's cuBLAS
// product equal to this fma chain bit for bit, and QK^T in 3xTF32 on the
// tensor cores faster but past 2e-5 of it there).  The online softmax
// keeps the scores as they are and takes exp(s - m) as exp2((s - m)
// log2(e)) on the SFU (ex2.approx), so the rounding of s log2(e) at large
// scores does not enter p.  O += P V runs on the tensor cores in 3xTF32:
// P (in registers: S's C fragment is the A fragment of mma.sync m16n8k8
// when the mma's k index tq stands for key 2tq and tq + 4 for key 2tq + 1)
// and V (read per fragment from shared memory) are each split into TF32
// parts, big = tf32(x) and small = tf32(x - big), rounded to nearest with
// ties away from zero, and P_small V_big + P_big V_small + P_big V_big sum
// to ~2^-22 of each p v; one TF32 product (~2^-11) misses 2e-5 at every
// size.  The mma's fp32 accumulation is not rounded to nearest: chained
// over a 32k-key row it drifts toward zero, to 0.8 of the 2e-5 limit, so
// each 4 key groups (12 mma) sum in a zeroed part that O takes in by an
// fp32 add.  Splitting V once a CTA into shared memory, in place of per
// fragment, was measured slower (src/repro_torch/bench/flash_f32_ab.py).
//
// flash_fwd, on the CUDA cores, fp32 throughout: f32 inputs with D > 128,
// and bf16 with D > 256.  A CTA of 8 warps takes 8 consecutive query rows of
// one (b, h), one warp per row, and one chunk of up to 256 output columns
// (gridDim.z chunks).
// It walks the keys in tiles of 32, staged in shared memory as fp32 (K
// rows of full D padded to D + 1 words so that lane j reading row j hits
// 32 banks; V only for the CTA's chunk).  In a tile, lane j computes the
// score of key j over all of D, the warp reduces the tile's max and sum
// with shuffles, and the lanes, which split the chunk, add p_j * v_j to
// their columns of the accumulator.  Its shared memory,
// 4 (32 (D + 1) + 32 min(D, 256) + 8 D) bytes, caps D at 1247 (227 KB).
//
// Bound: operations.  4 * B * H * D flops per visible (query, key) pair
// (QK^T and PV), over 989 TFLOP/s for bf16 inputs (the card's dense bf16
// tensor rate) or, for fp32, a third of its dense TF32 rate (494.7 TFLOP/s:
// fp32-accurate products take three TF32 ones); q, k, v and o move once
// (0.34 GB at B=1, H=32, Hkv=8, D=64, 32k).  mma.sync runs below the wgmma
// rate that the bounds assume; wgmma, TMA and warp specialisation are the
// next step.  flash_f32tc's own floor is its QK^T, half the flops, at the
// 67 TFLOP/s of the CUDA cores; its lanes also issue the TF32 splits, the
// softmax and 16-byte shared loads (~0.08 a fma).  flash_fwd issues
// ~(3D/32 + D/32 + 1) warp instructions per pair from shared memory, far
// from the fp32 rate.
//
// The kernels allocate nothing; every entry point launches on the given
// stream and returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// --- flash_fwd: CUDA cores ----------------------------------------------------

constexpr int kWarps = 8;
constexpr int kTile = 32;          // keys per shared-memory tile
constexpr int kChunk = 256;        // output columns per CTA
constexpr int kMaxHeadDim = 1247;  // shared_bytes(1247) <= 227 KB

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t shared_bytes(int D) {
  const int vw = D < kChunk ? D : kChunk;
  return sizeof(float) * ((size_t)kTile * (D + 1) + (size_t)kTile * vw +
                          (size_t)kWarps * D);
}

// NDL = ceil(min(D, 256) / 32): accumulator columns per lane.  kChunked:
// the CTA computes output columns [c0, c0 + cw) of chunk blockIdx.z;
// otherwise all D <= 256 of them.
template <typename T, int NDL, bool kChunked>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int c0 = kChunked ? blockIdx.z * kChunk : 0;
  const int cw = kChunked && D - c0 > kChunk ? kChunk : D - c0;
  const int vw = kChunked && D > kChunk ? kChunk : D;
  float* ks = smem;                    // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);    // [kTile][vw]: this CTA's columns
  float* qs = vs + kTile * vw;         // [kWarps][D]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;           // b * H + h
  const int64_t kvh = (int64_t)(bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = qtile * kWarps;
  const int row = row0 + warp;
  const bool active = row < Sq;
  const int off = Sk - Sq;

  float* qw = qs + warp * D;
  const T* qrow = q + ((int64_t)bh * Sq + row) * D;
  for (int d = lane; d < D; d += 32)
    qw[d] = active ? to_float(qrow[d]) * scale : 0.f;

  int kv_end = Sk;
  if (causal && row0 + off >= 0) {  // no fully masked row in this CTA
    const int last = (row0 + kWarps < Sq ? row0 + kWarps : Sq) - 1;
    kv_end = last + off + 1 < Sk ? last + off + 1 : Sk;
  }
  const T* kb = k + kvh * Sk * D;
  const T* vb = v + kvh * Sk * D;

  float m = kMasked, l = 0.f, acc[NDL];
#pragma unroll
  for (int t = 0; t < NDL; ++t) acc[t] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D;
      const bool in = j0 + r < Sk;
      const int64_t at = (int64_t)(j0 + r) * D + d;
      ks[r * (D + 1) + d] = in ? to_float(kb[at]) : 0.f;
      if (!kChunked || (d >= c0 && d < c0 + cw))
        vs[r * vw + d - c0] = in ? to_float(vb[at]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;  // every thread still meets both barriers

    const int kj = j0 + lane;
    const bool valid = kj < Sk;
    const float* krow = ks + lane * (D + 1);
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qw[d], krow[d], s);
    if (causal && row + off < kj) s = kMasked;
    const float m_new = fmaxf(m, warp_max(valid ? s : -INFINITY));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int t = 0; t < NDL; ++t) acc[t] *= corr;
    const int cnt = Sk - j0 < kTile ? Sk - j0 : kTile;
    for (int jj = 0; jj < cnt; ++jj) {
      const float pj = __shfl_sync(kFull, p, jj);
      const float* vrow = vs + jj * vw;
#pragma unroll
      for (int t = 0; t < NDL; ++t) {
        const int d = lane + 32 * t;
        if (d < cw) acc[t] = fmaf(pj, vrow[d], acc[t]);
      }
    }
    m = m_new;
  }
  if (!active) return;
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + ((int64_t)bh * Sq + row) * D + c0;
#pragma unroll
  for (int t = 0; t < NDL; ++t) {
    const int d = lane + 32 * t;
    if (d < cw) orow[d] = from_float<T>(acc[t] * inv_l);
  }
}

template <typename T, int NDL, bool kChunked = false>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = shared_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NDL, kChunked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kWarps - 1) / kWarps, B * H,
                  kChunked ? (D + kChunk - 1) / kChunk : 1);
  flash_fwd<T, NDL, kChunked><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, D, scale,
      causal);
  return cudaGetLastError();
}

bool valid_shapes(int B, int H, int Hkv, int Sq, int Sk, int D, int max_d) {
  return B >= 0 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 0 &&
         Sk >= 0 && D >= 1 && D <= max_d && (int64_t)B * H <= 65535;
}

// fp32: one column chunk for 128 < D <= 256, chunks of 256 above.  bf16:
// the chunked instance only (its entry point takes D > 256 alone).
template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hkv, int Sq, int Sk, int D, float scale, int causal,
        cudaStream_t stream) {
  if (!valid_shapes(B, H, Hkv, Sq, Sk, D, kMaxHeadDim))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (std::is_same_v<T, __nv_bfloat16> || D > kChunk)
    return launch<T, 8, true>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale,
                              causal, stream);
  if constexpr (std::is_same_v<T, float>) {
    switch ((D + 31) / 32) {
#define CASE(N) \
  case N:       \
    return launch<T, N>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
      CASE(5) CASE(6) CASE(7) CASE(8)  // its entry point takes D > 128
#undef CASE
    }
  }
  return cudaErrorInvalidValue;
}

// --- flash_tc: bf16 tensor cores (mma.sync m16n8k16, cp.async ring) ----------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcMaxHeadDim = 256;

// Tiles by padded head dim: kM m16 row tiles a warp (each K/V fragment
// feeds kM mma), kN keys a tile; the registers of S and O bound both.
template <int Dp>
struct TcTiles {
  static constexpr int kM = Dp == 64 ? 2 : 1;
  static constexpr int kRows = 16 * kM * kTcWarps;  // query rows a CTA
  static constexpr int kN = Dp <= 128 ? 64 : 32;
  static constexpr int kStride = Dp + 8;  // bf16 a shared row: 16 B of pad
  static constexpr size_t kBytes =        // Q + two stages of K and V
      sizeof(bf16) * (size_t)(kRows + 4 * kN) * kStride;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x0, x1) = hi + lo, each a bf16 pair: hi holds x's first 8 significant
// bits, lo the next 8, so hi + lo is within ~2^-17 of x (hi alone 2^-9)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}
// 2^x on the SFU (exp2f adds a range reduction); relative error ~2^-22,
// -1e30 gives 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + kRows) of a row-major (n, D) matrix into a [kRows][kStride]
// shared tile of Dp columns; zero past row n and past column D.  vec:
// 16-byte cp.async (D a multiple of 16 bytes' elements, 16-byte aligned
// base), else element loads.
template <int Dp, int kRows, int kStride = Dp + 8, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g, int r0, int n,
                                          int D, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T), kChunks = Dp / kVec;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kTcThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      const bool in = r0 + r < n && c < D;
      cp_async16(smem_u32(s + r * kStride + c),
                 in ? g + (int64_t)(r0 + r) * D + c : g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * Dp; i += kTcThreads) {
      const int r = i / Dp, c = i % Dp;
      s[r * kStride + c] =
          r0 + r < n && c < D ? g[(int64_t)(r0 + r) * D + c]
                              : from_float<T>(0.f);
    }
  }
}

// One key tile of the online softmax for the warp's rows: m the running
// max, p = exp(score - m) (p is left in s), l the lane's part of the row
// sum, O rescaled by exp(m_old - m).  kNatural: s holds scores already
// scaled (q was), m is in their units and exp(x) = exp2(x log2(e)) of the
// difference, which stays exact where p matters (fp32 at large scores);
// else x = s * scale_log2 and m are in the log2 domain (bf16).  kCheck:
// apply the causal mask (diag) and p = 0 past Sk.
template <bool kCheck, int kM, int kN, int Dp, bool kNatural = false>
__device__ __forceinline__ void softmax_tile(float (&s)[kM][kN / 8][4],
                                             float (&m)[kM][2],
                                             float (&l)[kM][2],
                                             float (&acc)[kM][Dp / 8][4],
                                             float scale_log2, bool diag,
                                             int qpos0, int j0, int Sk,
                                             int tq) {
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 16 * i + 8 * r;  // the row's last visible key
      float mx = m[i][r];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = j0 + 8 * j + 2 * tq + e;
          float x = kNatural ? s[i][j][2 * r + e]
                             : s[i][j][2 * r + e] * scale_log2;
          if (kCheck && diag && kpos > qpos) x = kMasked;
          s[i][j][2 * r + e] = x;
          if (!kCheck || kpos < Sk) mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float corr = kNatural ? fast_exp2((m[i][r] - mx) * kLog2e)
                                  : fast_exp2(m[i][r] - mx);
      m[i][r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = j0 + 8 * j + 2 * tq + e;
          const float x = s[i][j][2 * r + e] - mx;
          const float p = kCheck && kpos >= Sk
                              ? 0.f
                              : fast_exp2(kNatural ? x * kLog2e : x);
          s[i][j][2 * r + e] = p;
          sum += p;
        }
      }
      l[i][r] = l[i][r] * corr + sum;  // the quad sums it at the end
#pragma unroll
      for (int j = 0; j < Dp / 8; ++j) {
        acc[i][j][2 * r] *= corr;
        acc[i][j][2 * r + 1] *= corr;
      }
    }
  }
}

template <int Dp>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int H,
             int Hkv, int Sq, int Sk, int D, float scale_log2, int causal,
             int vec) {
  using Tiles = TcTiles<Dp>;
  constexpr int kM = Tiles::kM, kRows = Tiles::kRows, kN = Tiles::kN;
  constexpr int kStride = Tiles::kStride;
  constexpr bool kQInRegs = Dp * kM <= 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kRows][kStride]
  bf16* ks = qs + kRows * kStride;              // [2][kN][kStride]
  bf16* vs = ks + 2 * kN * kStride;             // [2][kN][kStride]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row and column pair
  const int bh = blockIdx.y;              // b * H + h
  const int64_t kvh = (int64_t)(bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = qtile * kRows;
  const int off = Sk - Sq;
  int kv_end = Sk;
  if (causal && row0 + off >= 0) {  // no fully masked row in this CTA
    const int last = (row0 + kRows < Sq ? row0 + kRows : Sq) - 1;
    kv_end = last + off + 1 < Sk ? last + off + 1 : Sk;
  }
  const int n_tiles = (kv_end + kN - 1) / kN;
  const bf16* qb = q + (int64_t)bh * Sq * D;
  const bf16* kb = k + kvh * Sk * D;
  const bf16* vb = v + kvh * Sk * D;

  load_tile<Dp, kRows>(qs, qb, row0, Sq, D, vec);
  load_tile<Dp, kN>(ks, kb, 0, Sk, D, vec);
  load_tile<Dp, kN>(vs, vb, 0, Sk, D, vec);
  cp_async_commit();

  // ldmatrix row addresses.  A (Q) and V^T (.trans): matrices (rows 0-7,
  // cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15), lanes 8i..8i+7 give
  // matrix i's rows.  K: (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15), i.e. b0, b1 of key group 2jp, then of 2jp + 1.
  const int a_row = (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
  const int wrow = warp * 16 * kM;  // the warp's first row in the CTA
  const uint32_t q_addr = smem_u32(qs + (wrow + a_row) * kStride + a_col);

  uint32_t qf[kQInRegs ? kM : 1][kQInRegs ? Dp / 16 : 1][4];
  // O of m-tile i: c0, c1 row g; c2, c3 row g + 8; columns 8j + 2tq + (0, 1)
  float acc[kM][Dp / 8][4];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float m[kM][2], l[kM][2];  // rows g, g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < kM; ++i)
    m[i][0] = m[i][1] = kMasked, l[i][0] = l[i][1] = 0.f;
  const int qpos0 = row0 + wrow + g + off;  // row g's last visible key

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and at t = 0 Q) landed, this thread's
    __syncthreads();      // ... and every thread's; tile t - 1 is consumed
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_tile<Dp, kN>(ks + st * kN * kStride, kb, (t + 1) * kN, Sk, D,
                        vec);
      load_tile<Dp, kN>(vs + st * kN * kStride, vb, (t + 1) * kN, Sk, D,
                        vec);
      cp_async_commit();
    }
    if constexpr (kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int kk = 0; kk < Dp / 16; ++kk)
            ldmatrix_x4(qf[i][kk], q_addr + (i * 16 * kStride + kk * 16) * 2);
      }
    }
    const bf16* kt = ks + (t & 1) * kN * kStride;
    const bf16* vt = vs + (t & 1) * kN * kStride;
    const int j0 = t * kN;

    // S = Q K^T: s[i][j] holds keys j0 + 8j + 2tq + (0, 1) of m-tile i
    float s[kM][kN / 8][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
        s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
    const uint32_t k_addr = smem_u32(kt + b_row * kStride + b_col);
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
      uint32_t a[kM][4];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        if constexpr (kQInRegs) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[i][r] = qf[i][kk][r];
        } else {
          ldmatrix_x4(a[i], q_addr + (i * 16 * kStride + kk * 16) * 2);
        }
      }
#pragma unroll
      for (int jp = 0; jp < kN / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, k_addr + (jp * 16 * kStride + kk * 16) * 2);
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          mma_bf16(s[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(s[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }

    // online softmax in the log2 domain; masks only where a tile crosses
    // the diagonal or passes Sk
    const bool diag = causal && j0 + kN - 1 > row0 + off;
    if (diag || j0 + kN > Sk)
      softmax_tile<true, kM, kN, Dp>(s, m, l, acc, scale_log2, diag, qpos0,
                                     j0, Sk, tq);
    else
      softmax_tile<false, kM, kN, Dp>(s, m, l, acc, scale_log2, false, qpos0,
                                      j0, Sk, tq);

    // O += P V as P_hi V + P_lo V (split_bf16): P's A fragment for keys
    // 16kk.. is S's key groups 2kk, 2kk + 1
    const uint32_t v_addr = smem_u32(vt + a_row * kStride + a_col);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t hi[kM][4], lo[kM][4];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(s[i][2 * kk + r / 2][2 * (r % 2)],
                     s[i][2 * kk + r / 2][2 * (r % 2) + 1], hi[i][r],
                     lo[i][r]);
      }
#pragma unroll
      for (int dp = 0; dp < Dp / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_addr + (kk * 16 * kStride + dp * 16) * 2);
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          mma_bf16(acc[i][2 * dp], lo[i], b[0], b[1]);
          mma_bf16(acc[i][2 * dp], hi[i], b[0], b[1]);
          mma_bf16(acc[i][2 * dp + 1], lo[i], b[2], b[3]);
          mma_bf16(acc[i][2 * dp + 1], hi[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // nothing may still land in qs (Sk = 0: no tile)

  // epilogue: O / l in bf16 into this warp's rows of qs (read only by this
  // warp), then 16-byte stores of the rows below Sq
  bf16* os = qs + wrow * kStride;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[i][r];
      lr += __shfl_xor_sync(kFull, lr, 1);
      lr += __shfl_xor_sync(kFull, lr, 2);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
#pragma unroll
      for (int j = 0; j < Dp / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            os + (16 * i + g + 8 * r) * kStride + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[i][j][2 * r] * inv,
                                  acc[i][j][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  const int rows = Sq - row0 - wrow < 16 * kM ? Sq - row0 - wrow : 16 * kM;
  bf16* ob = o + ((int64_t)bh * Sq + row0 + wrow) * D;
  if (vec) {
    const int chunks = D / 8;
    for (int i = lane; i < rows * chunks; i += 32) {
      const int r = i / chunks, c = (i % chunks) * 8;
      *reinterpret_cast<int4*>(ob + (int64_t)r * D + c) =
          *reinterpret_cast<const int4*>(os + r * kStride + c);
    }
  } else {
    for (int i = lane; i < rows * D; i += 32) {
      const int r = i / D, c = i % D;
      ob[(int64_t)r * D + c] = os[r * kStride + c];
    }
  }
}

template <int Dp>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
              cudaStream_t stream) {
  using Tiles = TcTiles<Dp>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tiles::kBytes);
  if (err != cudaSuccess) return err;
  const bool vec = D % 8 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)o) % 16 == 0;
  const dim3 grid((Sq + Tiles::kRows - 1) / Tiles::kRows, B * H);
  flash_tc<Dp><<<grid, kTcThreads, Tiles::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Hkv, Sq, Sk, D,
      scale * kLog2e, causal, vec);
  return cudaGetLastError();
}

int run_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  if (!valid_shapes(B, H, Hkv, Sq, Sk, D, kTcMaxHeadDim))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (D <= 64)
    return launch_tc<64>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                         stream);
  if (D <= 128)
    return launch_tc<128>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                          stream);
  return launch_tc<256>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                        stream);
}

// --- flash_f32tc: fp32, QK^T on the CUDA cores, PV as 3xTF32 mma.sync --------

constexpr int kF32TcMaxHeadDim = 128;
// 8-key groups whose P V the tensor cores sum in a zeroed part before O
// takes it in by an fp32 add (see f32_pv)
constexpr int kPvGroups = 4;

// Tiles by padded head dim: kM m16 row tiles a warp, kN keys a tile.  Rows
// of Dp + 4 floats: the float4 loads of QK^T (rows g of Q, rows 2tq + e of
// K) and the 32-bit loads of V's B fragment (rows 2tq, 2tq + 1, column g)
// then fall in distinct banks.
template <int Dp>
struct F32Tiles {
  static constexpr int kM = Dp == 64 ? 2 : 1;
  static constexpr int kRows = 16 * kM * kTcWarps;  // query rows a CTA
  static constexpr int kN = 64;
  static constexpr int kStride = Dp + 4;
  static constexpr size_t kBytes =  // Q + two stages of K and V
      sizeof(float) * (size_t)(kRows + 4 * kN) * kStride;
};

// x rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds: half a TF32 ulp added to the magnitude's
// bits, the 13 bits below it cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small to ~2^-22 of x: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}
// c += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S = (q scale) K^T on the CUDA cores, each score one fma chain over d = 0,
// 1, ..., the order of the reference's fp32 product: at large scores any
// other order (the 8-wide sums of a tensor-core mma) moves the output past
// 2e-5 of it.  qrow: the lane's row g of the warp's first m-tile; kt: the
// key tile.  s[i][j] holds keys 8j + 2tq + (0, 1) of rows g, g + 8 of
// m-tile i (the mma C layout that P V takes as A).
template <int Dp, int kM, int kN, int kStride>
__device__ __forceinline__ void f32_scores(float (&s)[kM][kN / 8][4],
                                           const float* qrow, const float* kt,
                                           int tq) {
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
  const float* krow = kt + 2 * tq * kStride;
#pragma unroll 1
  for (int d = 0; d < Dp; d += 4) {
    float4 qv[kM][2];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qv[i][r] = *reinterpret_cast<const float4*>(
            qrow + (16 * i + 8 * r) * kStride + d);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kv = *reinterpret_cast<const float4*>(
            krow + (8 * j + e) * kStride + d);
#pragma unroll
        for (int i = 0; i < kM; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = s[i][j][2 * r + e];
            x = fmaf(qv[i][r].x, kv.x, x);
            x = fmaf(qv[i][r].y, kv.y, x);
            x = fmaf(qv[i][r].z, kv.z, x);
            s[i][j][2 * r + e] = fmaf(qv[i][r].w, kv.w, x);
          }
        }
      }
    }
  }
}

// P's TF32 parts for the mma A fragment of key group j: the mma's k index
// tq stands for key 2tq of the group and tq + 4 for key 2tq + 1, so S's C
// fragment is P's A fragment as it stands (no shuffle)
template <int kN>
__device__ __forceinline__ void split_p(const float (&p)[kN / 8][4], int j,
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  split_tf32(p[j][0], big[0], small[0]);  // row g, key 2tq
  split_tf32(p[j][2], big[1], small[1]);  // row g + 8, key 2tq
  split_tf32(p[j][1], big[2], small[2]);  // row g, key 2tq + 1
  split_tf32(p[j][3], big[3], small[3]);  // row g + 8, key 2tq + 1
}

// O += P V in 3xTF32: P_small V_big + P_big V_small + P_big V_big, each part
// rounded to TF32 (split_tf32); V's B fragment is rows 2tq, 2tq + 1 at
// column g, split per fragment in registers.  The tensor cores sum
// kPvGroups key groups (3 mma each) into a zeroed part, which O takes in by
// an fp32 add: their accumulation is not rounded to nearest, and chained
// over a 32k-key row it drifts toward the limit of the reference.
template <int Dp, int kM, int kN, int kStride>
__device__ __forceinline__ void f32_pv(float (&acc)[kM][Dp / 8][4],
                                       const float (&p)[kM][kN / 8][4],
                                       const float* vt, int g, int tq) {
  static_assert(kN % (8 * kPvGroups) == 0, "a tile holds whole groups");
  const float* vrow = vt + 2 * tq * kStride + g;
#pragma unroll
  for (int j0 = 0; j0 < kN / 8; j0 += kPvGroups) {
    uint32_t pb[kM][kPvGroups][4], ps[kM][kPvGroups][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int jj = 0; jj < kPvGroups; ++jj)
        split_p<kN>(p[i], j0 + jj, pb[i][jj], ps[i][jj]);
#pragma unroll
    for (int dp = 0; dp < Dp / 8; ++dp) {
      float part[kM][4] = {};
#pragma unroll
      for (int jj = 0; jj < kPvGroups; ++jj) {
        const float* vg = vrow + 8 * (j0 + jj) * kStride + 8 * dp;
        uint32_t vb0, vb1, vs0, vs1;  // big and small of the two keys
        split_tf32(vg[0], vb0, vs0);
        split_tf32(vg[kStride], vb1, vs1);
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          mma_tf32(part[i], ps[i][jj], vb0, vb1);
          mma_tf32(part[i], pb[i][jj], vs0, vs1);
          mma_tf32(part[i], pb[i][jj], vb0, vb1);
        }
      }
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][dp][e] += part[i][e];
    }
  }
}

// The epilogue: O / l into the warp's rows of shared memory os (read only by
// this warp), then stores of its first `rows` rows to ob (16-byte if vec)
template <int Dp, int kM, int kStride>
__device__ __forceinline__ void f32_store(float* os, float* ob,
                                          const float (&acc)[kM][Dp / 8][4],
                                          const float (&l)[kM][2], int rows,
                                          int D, bool vec) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[i][r];
      lr += __shfl_xor_sync(kFull, lr, 1);
      lr += __shfl_xor_sync(kFull, lr, 2);
      lr = fmaxf(lr, 1e-30f);
#pragma unroll
      for (int j = 0; j < Dp / 8; ++j)
        *reinterpret_cast<float2*>(os + (16 * i + g + 8 * r) * kStride +
                                   8 * j + 2 * tq) =
            make_float2(acc[i][j][2 * r] / lr, acc[i][j][2 * r + 1] / lr);
    }
  }
  __syncwarp();
  if (vec) {
    const int chunks = D / 4;
    for (int i = lane; i < rows * chunks; i += 32) {
      const int r = i / chunks, c = (i % chunks) * 4;
      *reinterpret_cast<float4*>(ob + (int64_t)r * D + c) =
          *reinterpret_cast<const float4*>(os + r * kStride + c);
    }
  } else {
    for (int i = lane; i < rows * D; i += 32) {
      const int r = i / D, c = i % D;
      ob[(int64_t)r * D + c] = os[r * kStride + c];
    }
  }
}

template <int Dp>
__global__ void __launch_bounds__(kTcThreads)
    flash_f32tc(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int Hkv, int Sq, int Sk, int D, float scale, int causal,
                int vec) {
  using Tiles = F32Tiles<Dp>;
  constexpr int kM = Tiles::kM, kRows = Tiles::kRows, kN = Tiles::kN;
  constexpr int kStride = Tiles::kStride;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* qs = reinterpret_cast<float*>(f32_smem);  // [kRows][kStride]
  float* ks = qs + kRows * kStride;                // [2][kN][kStride]
  float* vs = ks + 2 * kN * kStride;               // [2][kN][kStride]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row and column pair
  const int bh = blockIdx.y;              // b * H + h
  const int64_t kvh = (int64_t)(bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = qtile * kRows;
  const int off = Sk - Sq;
  int kv_end = Sk;
  if (causal && row0 + off >= 0) {  // no fully masked row in this CTA
    const int last = (row0 + kRows < Sq ? row0 + kRows : Sq) - 1;
    kv_end = last + off + 1 < Sk ? last + off + 1 : Sk;
  }
  const int n_tiles = (kv_end + kN - 1) / kN;
  const float* qb = q + (int64_t)bh * Sq * D;
  const float* kb = k + kvh * Sk * D;
  const float* vb = v + kvh * Sk * D;

  load_tile<Dp, kRows, kStride>(qs, qb, row0, Sq, D, vec);
  load_tile<Dp, kN, kStride>(ks, kb, 0, Sk, D, vec);
  load_tile<Dp, kN, kStride>(vs, vb, 0, Sk, D, vec);
  cp_async_commit();

  const int wrow = warp * 16 * kM;  // the warp's first row in the CTA
  // O of m-tile i: c0, c1 row g; c2, c3 row g + 8; columns 8j + 2tq + (0, 1)
  float acc[kM][Dp / 8][4];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float m[kM][2], l[kM][2];  // rows g, g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < kM; ++i)
    m[i][0] = m[i][1] = kMasked, l[i][0] = l[i][1] = 0.f;
  const int qpos0 = row0 + wrow + g + off;  // row g's last visible key
  const float* qrow = qs + (wrow + g) * kStride;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and at t = 0 Q) landed, this thread's
    __syncthreads();      // ... and every thread's; tile t - 1 is consumed
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_tile<Dp, kN, kStride>(ks + st * kN * kStride, kb, (t + 1) * kN,
                                 Sk, D, vec);
      load_tile<Dp, kN, kStride>(vs + st * kN * kStride, vb, (t + 1) * kN,
                                 Sk, D, vec);
      cp_async_commit();
    }
    if (t == 0) {  // q * scale in fp32, as the reference scales q; the
                   // warp's own rows, which only it reads
      float* qw = qs + wrow * kStride;
      for (int i = lane; i < 16 * kM * Dp; i += 32)
        qw[(i / Dp) * kStride + i % Dp] *= scale;
      __syncwarp();
    }
    const int j0 = t * kN;
    float s[kM][kN / 8][4];
    f32_scores<Dp, kM, kN, kStride>(s, qrow, ks + (t & 1) * kN * kStride,
                                    tq);
    // online softmax on the scores as they are (natural domain); masks
    // only where a tile crosses the diagonal or passes Sk
    const bool diag = causal && j0 + kN - 1 > row0 + off;
    if (diag || j0 + kN > Sk)
      softmax_tile<true, kM, kN, Dp, true>(s, m, l, acc, 0.f, diag, qpos0, j0,
                                           Sk, tq);
    else
      softmax_tile<false, kM, kN, Dp, true>(s, m, l, acc, 0.f, false, qpos0,
                                            j0, Sk, tq);
    f32_pv<Dp, kM, kN, kStride>(acc, s, vs + (t & 1) * kN * kStride, g, tq);
  }
  cp_async_wait_all();  // nothing may still land in qs (Sk = 0: no tile)

  const int rows = Sq - row0 - wrow < 16 * kM ? Sq - row0 - wrow : 16 * kM;
  f32_store<Dp, kM, kStride>(qs + wrow * kStride,
                             o + ((int64_t)bh * Sq + row0 + wrow) * D, acc, l,
                             rows, D, vec);
}

template <int Dp>
int launch_f32tc(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Hkv, int Sq, int Sk, int D, float scale,
                 int causal, cudaStream_t stream) {
  using Tiles = F32Tiles<Dp>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32tc<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tiles::kBytes);
  if (err != cudaSuccess) return err;
  const bool vec = D % 4 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)o) % 16 == 0;
  const dim3 grid((Sq + Tiles::kRows - 1) / Tiles::kRows, B * H);
  flash_f32tc<Dp><<<grid, kTcThreads, Tiles::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Sk, D,
      scale, causal, vec);
  return cudaGetLastError();
}

int run_f32tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
              cudaStream_t stream) {
  if (!valid_shapes(B, H, Hkv, Sq, Sk, D, kF32TcMaxHeadDim))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (D <= 64)
    return launch_f32tc<64>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                            stream);
  return launch_f32tc<128>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                           stream);
}

}  // namespace

extern "C" {

// q: B*H*Sq*D, k and v: B*Hkv*Sk*D, o: B*H*Sq*D, contiguous, of the entry
// point's dtype.  scale: 1/sqrt(D) as fp32.  causal: 0 or 1.  Returns a
// cudaError_t (cudaErrorInvalidValue for a D the kernel does not take).

// fp32, D <= 128: QK^T on the CUDA cores, PV on the tensor cores (3xTF32)
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Hkv, int Sq, int Sk, int D,
                        float scale, int causal, void* stream) {
  return run_f32tc(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                   static_cast<cudaStream_t>(stream));
}

// CUDA cores, 128 < D <= 1247: the head dims flash_attention_f32 does not
// take, and no other (cudaErrorInvalidValue)
int flash_attention_f32_cuda_cores(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int Sq, int Sk, int D,
                                   float scale, int causal, void* stream) {
  if (D <= kF32TcMaxHeadDim) return cudaErrorInvalidValue;
  return run<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                    static_cast<cudaStream_t>(stream));
}

// tensor cores, D <= 256
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Hkv, int Sq, int Sk, int D,
                         float scale, int causal, void* stream) {
  return run_tc(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                static_cast<cudaStream_t>(stream));
}

// CUDA cores, 256 < D <= 1247: the head dims flash_attention_bf16 does not
// take, and no other (cudaErrorInvalidValue)
int flash_attention_bf16_cuda_cores(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int Sq, int Sk, int D,
                                    float scale, int causal, void* stream) {
  if (D <= kTcMaxHeadDim) return cudaErrorInvalidValue;
  return run<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                            static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
