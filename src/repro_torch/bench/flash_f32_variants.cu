// A/B variants of kernels/csrc/flash_attention.cu's fp32 tensor-core kernel
// (flash_f32tc), built only by flash_f32_ab.py, one nvcc per variant.  The
// switches below default to the shipped kernel's design:
//
//   QK_PRODUCTS  0: S = (q scale) K^T as one fma chain over d a score on the
//                CUDA cores (shipped); 3: on the tensor cores in 3xTF32
//                (mma.sync m16n8k8, Q and K split per fragment into TF32 big
//                + small, Q_small K_big + Q_big K_small + Q_big K_big, 8 d a
//                mma, the sum chained over d in the accumulators); 1: one
//                TF32 product (Q_big K_big)
//   PV_GROUPS    8-key groups of P V summed in a zeroed part before O takes
//                it in by an fp32 add (shipped 4); 0: the mma sum straight
//                into O's accumulators over the whole row
//   KEYS         keys a tile (shipped 64)
//   V_STAGED     1: V split into its TF32 parts once a tile, in shared memory
//                (big over V, small over the consumed K tile), in place of a
//                split per fragment in registers (shipped 0)
//
// The tile loads, the online softmax, the TF32 split, the fma-chain scores
// and the epilogue are the shipped file's own, included below.
// f32_scores_fma_chain computes one head's S a thread a score, one fma chain
// over d as the shipped kernel sums it, so that the script can hold the
// card's plain version (a cuBLAS fp32 product) to that order bit for bit.

#include "../kernels/csrc/flash_attention.cu"

#ifndef QK_PRODUCTS
#define QK_PRODUCTS 0
#endif
#ifndef PV_GROUPS
#define PV_GROUPS 4
#endif
#ifndef KEYS
#define KEYS 64
#endif
#ifndef V_STAGED
#define V_STAGED 0
#endif

namespace {

static_assert(QK_PRODUCTS == 0 || QK_PRODUCTS == 1 || QK_PRODUCTS == 3,
              "QK_PRODUCTS is 0 (fma chain), 1 or 3 (TF32 products)");
constexpr int kVarGroups = PV_GROUPS == 0 ? 1 : PV_GROUPS;

template <int Dp>
struct VarTiles {
  static constexpr int kM = F32Tiles<Dp>::kM, kRows = F32Tiles<Dp>::kRows;
  static constexpr int kN = KEYS;
  static_assert(kN % (8 * kVarGroups) == 0, "a tile holds whole groups");
  static constexpr int kStride = Dp + 4;
  static constexpr size_t kBytes =  // Q + two stages of K and V
      sizeof(float) * (size_t)(kRows + 4 * kN) * kStride;
};

// S = (q scale) K^T on the tensor cores, 8 d a mma.  A fragment of m-tile
// i: rows g, g + 8 at d0 + tq, d0 + tq + 4; B fragment of key group j: key
// 8j + g at d0 + tq, d0 + tq + 4 (rows of Dp + 4 floats: 32 banks)
template <int Dp, int kM, int kN, int kStride>
__device__ __forceinline__ void scores_mma(float (&s)[kM][kN / 8][4],
                                           const float* qrow, const float* kt,
                                           int g, int tq) {
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < Dp; d0 += 8) {
    uint32_t qb[kM][4], qsm[kM][4];
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const float* r = qrow + 16 * i * kStride + d0 + tq;
      split_tf32(r[0], qb[i][0], qsm[i][0]);
      split_tf32(r[8 * kStride], qb[i][1], qsm[i][1]);
      split_tf32(r[4], qb[i][2], qsm[i][2]);
      split_tf32(r[8 * kStride + 4], qb[i][3], qsm[i][3]);
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float* kr = kt + (8 * j + g) * kStride + d0 + tq;
      uint32_t kb0, kb1, ks0, ks1;
      split_tf32(kr[0], kb0, ks0);
      split_tf32(kr[4], kb1, ks1);
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        if constexpr (QK_PRODUCTS == 3) {
          mma_tf32(s[i][j], qsm[i], kb0, kb1);
          mma_tf32(s[i][j], qb[i], ks0, ks1);
        }
        mma_tf32(s[i][j], qb[i], kb0, kb1);
      }
    }
  }
}

// O += P V in 3xTF32 as f32_pv sums it, with PV_GROUPS and V_STAGED
// (vsmall: V's small parts, at vt's offsets)
template <int Dp, int kM, int kN, int kStride>
__device__ __forceinline__ void pv_variant(float (&acc)[kM][Dp / 8][4],
                                           const float (&p)[kM][kN / 8][4],
                                           const float* vt,
                                           const float* vsmall, int g,
                                           int tq) {
  const float* vrow = vt + 2 * tq * kStride + g;
#pragma unroll
  for (int j0 = 0; j0 < kN / 8; j0 += kVarGroups) {
    uint32_t pb[kM][kVarGroups][4], ps[kM][kVarGroups][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int jj = 0; jj < kVarGroups; ++jj)
        split_p<kN>(p[i], j0 + jj, pb[i][jj], ps[i][jj]);
#pragma unroll
    for (int dp = 0; dp < Dp / 8; ++dp) {
      float part[kM][4] = {};
#pragma unroll
      for (int jj = 0; jj < kVarGroups; ++jj) {
        const float* vg = vrow + 8 * (j0 + jj) * kStride + 8 * dp;
        uint32_t vb0, vb1, vs0, vs1;  // big and small of the two keys
        if constexpr (V_STAGED) {
          const float* sg = vsmall + (vg - vt);
          vb0 = __float_as_uint(vg[0]), vb1 = __float_as_uint(vg[kStride]);
          vs0 = __float_as_uint(sg[0]), vs1 = __float_as_uint(sg[kStride]);
        } else {
          split_tf32(vg[0], vb0, vs0);
          split_tf32(vg[kStride], vb1, vs1);
        }
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          float(&sum)[4] = PV_GROUPS == 0 ? acc[i][dp] : part[i];
          mma_tf32(sum, ps[i][jj], vb0, vb1);
          mma_tf32(sum, pb[i][jj], vs0, vs1);
          mma_tf32(sum, pb[i][jj], vb0, vb1);
        }
      }
      if constexpr (PV_GROUPS != 0) {
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][dp][e] += part[i][e];
      }
    }
  }
}

// flash_f32tc's frame with the variant's scores, tile and P V
template <int Dp>
__global__ void __launch_bounds__(kTcThreads)
    flash_f32_variant(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int H, int Hkv, int Sq, int Sk, int D, float scale,
                      int causal, int vec) {
  using Tiles = VarTiles<Dp>;
  constexpr int kM = Tiles::kM, kRows = Tiles::kRows, kN = Tiles::kN;
  constexpr int kStride = Tiles::kStride;
  extern __shared__ __align__(16) unsigned char var_smem[];
  float* qs = reinterpret_cast<float*>(var_smem);  // [kRows][kStride]
  float* ks = qs + kRows * kStride;                // [2][kN][kStride]
  float* vs = ks + 2 * kN * kStride;               // [2][kN][kStride]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int bh = blockIdx.y;
  const int64_t kvh = (int64_t)(bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = qtile * kRows;
  const int off = Sk - Sq;
  int kv_end = Sk;
  if (causal && row0 + off >= 0) {
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

  const int wrow = warp * 16 * kM;
  float acc[kM][Dp / 8][4];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int i = 0; i < kM; ++i)
    m[i][0] = m[i][1] = kMasked, l[i][0] = l[i][1] = 0.f;
  const int qpos0 = row0 + wrow + g + off;
  const float* qrow = qs + (wrow + g) * kStride;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_tile<Dp, kN, kStride>(ks + st * kN * kStride, kb, (t + 1) * kN,
                                 Sk, D, vec);
      load_tile<Dp, kN, kStride>(vs + st * kN * kStride, vb, (t + 1) * kN,
                                 Sk, D, vec);
      cp_async_commit();
    }
    if (t == 0) {
      float* qw = qs + wrow * kStride;
      for (int i = lane; i < 16 * kM * Dp; i += 32)
        qw[(i / Dp) * kStride + i % Dp] *= scale;
      __syncwarp();
    }
    float* kt = ks + (t & 1) * kN * kStride;
    float* vt = vs + (t & 1) * kN * kStride;
    const int j0 = t * kN;
    float s[kM][kN / 8][4];
    if constexpr (QK_PRODUCTS == 0)
      f32_scores<Dp, kM, kN, kStride>(s, qrow, kt, tq);
    else
      scores_mma<Dp, kM, kN, kStride>(s, qrow, kt, g, tq);
    const bool diag = causal && j0 + kN - 1 > row0 + off;
    if (diag || j0 + kN > Sk)
      softmax_tile<true, kM, kN, Dp, true>(s, m, l, acc, 0.f, diag, qpos0, j0,
                                           Sk, tq);
    else
      softmax_tile<false, kM, kN, Dp, true>(s, m, l, acc, 0.f, false, qpos0,
                                            j0, Sk, tq);
    if constexpr (V_STAGED) {  // every warp has its scores: K is free
      __syncthreads();
      for (int i = threadIdx.x; i < kN * Dp; i += kTcThreads) {
        float* x = vt + (i / Dp) * kStride + i % Dp;
        uint32_t big, small;
        split_tf32(*x, big, small);
        *x = __uint_as_float(big);
        kt[x - vt] = __uint_as_float(small);
      }
      __syncthreads();
    }
    pv_variant<Dp, kM, kN, kStride>(acc, s, vt, kt, g, tq);
  }
  cp_async_wait_all();

  const int rows = Sq - row0 - wrow < 16 * kM ? Sq - row0 - wrow : 16 * kM;
  f32_store<Dp, kM, kStride>(qs + wrow * kStride,
                             o + ((int64_t)bh * Sq + row0 + wrow) * D, acc, l,
                             rows, D, vec);
}

template <int Dp>
int launch_variant(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                   int causal, cudaStream_t stream) {
  using Tiles = VarTiles<Dp>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_variant<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tiles::kBytes);
  if (err != cudaSuccess) return err;
  const bool vec = D % 4 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)o) % 16 == 0;
  const dim3 grid((Sq + Tiles::kRows - 1) / Tiles::kRows, B * H);
  flash_f32_variant<Dp><<<grid, kTcThreads, Tiles::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Sk, D,
      scale, causal, vec);
  return cudaGetLastError();
}

// s[i][j] = (q_i scale) . k_j, one fma chain over d = 0, 1, ...
__global__ void scores_fma_chain(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 float* __restrict__ s, int Sk, int D,
                                 float scale) {
  const int i = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Sk) return;
  float x = 0.f;
  for (int d = 0; d < D; ++d)
    x = fmaf(__fmul_rn(q[(int64_t)i * D + d], scale), k[(int64_t)j * D + d],
             x);
  s[(int64_t)i * Sk + j] = x;
}

}  // namespace

extern "C" {

// as flash_attention_f32 (D <= 128), with the variant's design
int flash_attention_f32_variant(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Hkv, int Sq, int Sk,
                                int D, float scale, int causal, void* stream) {
  if (!valid_shapes(B, H, Hkv, Sq, Sk, D, kF32TcMaxHeadDim))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const auto launch = D <= 64 ? launch_variant<64> : launch_variant<128>;
  return launch(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                static_cast<cudaStream_t>(stream));
}

// q (Sq, D), k (Sk, D), s (Sq, Sk), contiguous fp32
int f32_scores_fma_chain(const void* q, const void* k, void* s, int Sq,
                         int Sk, int D, float scale, void* stream) {
  if (Sq == 0 || Sk == 0) return cudaSuccess;
  scores_fma_chain<<<dim3((Sk + 127) / 128, Sq), 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(s), Sk, D, scale);
  return cudaGetLastError();
}

}  // extern "C"
