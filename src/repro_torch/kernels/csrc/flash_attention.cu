// Forward attention with an online softmax for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel: q (B, H, Sq, D), k and v (B, Hkv, Sk, D) with H a multiple of
// Hkv, output (B, H, Sq, D) in q's dtype.  What it computes, as the TPU
// kernel does:
//   * q is cast to fp32 and then scaled by 1/sqrt(D) (the wrapper passes
//     the scale rounded to fp32); scores, m, l and the accumulator are fp32;
//   * GQA by index: query head h reads kv head h / (H / Hkv), no copy;
//   * causal mask q_pos + (Sk - Sq) >= k_pos, with masked scores set to
//     -1e30 and m starting at -1e30, not -inf: a query row whose keys are
//     all masked (causal with Sk < Sq) then weighs every key equally and
//     gets the mean of V, where the jnp references give NaN;
//   * output acc / max(l, 1e-30), cast to q's dtype (round to nearest even
//     for bf16).
//
// Design (a first, simple kernel on the CUDA cores; no tensor cores yet):
// a CTA of 8 warps takes 8 consecutive query rows of one (b, h), one warp
// per row.  It walks the keys in tiles of 32, staged in shared memory as
// fp32 (K rows padded to D + 1 words so that lane j reading row j hits 32
// banks).  In a tile, lane j computes the score of key j, the warp reduces
// the tile's max and sum with shuffles, and the lanes, which split D, add
// p_j * v_j to their columns of the accumulator.  Under the causal mask a
// CTA stops at its last row's last visible key: the skipped tiles would
// add exp(-1e30 - m) = 0 to l and to the accumulator and leave m as it is.
// A CTA that holds a fully masked row walks every key, as that row must
// average all of V.  Key tiles past Sk add nothing (p = 0, not -1e30).
// Causal CTAs are issued longest first (reversed q-tile order).
//
// Bound: operations.  4 * B * H * D flops per visible (query, key) pair
// (QK^T and PV), over 989 TFLOP/s for bf16 inputs (the card's bf16 tensor
// rate) or 67 TFLOP/s for fp32 (its fp32 rate outside the tensor cores);
// q, k, v and o move once (0.34 GB at B=1, H=32, Hkv=8, D=64, 32k).  This
// kernel issues ~(3D/32 + D/32 + 1) warp instructions per pair from shared
// memory, far from either rate: tensor cores (wgmma) and TMA come with the
// redesign.
//
// Head dims 1..256 (the repro's configs use 4, 64, 112, 128 and 160).  The
// kernel allocates nothing; every entry point launches on the given stream
// and returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;          // keys per shared-memory tile
constexpr int kMaxHeadDim = 256;
constexpr float kMasked = -1e30f;  // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

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
  return sizeof(float) * ((size_t)kTile * (D + 1) + (size_t)kTile * D +
                          (size_t)kWarps * D);
}

// NDL = ceil(D / 32): accumulator columns per lane.
template <typename T, int NDL>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;                    // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);    // [kTile][D]
  float* qs = vs + kTile * D;          // [kWarps][D]
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
      vs[r * D + d] = in ? to_float(vb[at]) : 0.f;
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
      const float* vrow = vs + jj * D;
#pragma unroll
      for (int t = 0; t < NDL; ++t) {
        const int d = lane + 32 * t;
        if (d < D) acc[t] = fmaf(pj, vrow[d], acc[t]);
      }
    }
    m = m_new;
  }
  if (!active) return;
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + ((int64_t)bh * Sq + row) * D;
#pragma unroll
  for (int t = 0; t < NDL; ++t) {
    const int d = lane + 32 * t;
    if (d < D) orow[d] = from_float<T>(acc[t] * inv_l);
  }
}

template <typename T, int NDL>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = shared_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kWarps - 1) / kWarps, B * H);
  flash_fwd<T, NDL><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, D, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hkv, int Sq, int Sk, int D, float scale, int causal,
        cudaStream_t stream) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv || Sq < 0 || Sk < 0 || D < 1 ||
      D > kMaxHeadDim || (int64_t)B * H > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  switch ((D + 31) / 32) {
#define CASE(N) \
  case N:       \
    return launch<T, N>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: B*H*Sq*D, k and v: B*Hkv*Sk*D, o: B*H*Sq*D, all float32 or all
// bfloat16, contiguous.  scale: 1/sqrt(D) as fp32.  causal: 0 or 1.
// Returns a cudaError_t.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Hkv, int Sq, int Sk, int D,
                        float scale, int causal, void* stream) {
  return run<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                    static_cast<cudaStream_t>(stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Hkv, int Sq, int Sk, int D,
                         float scale, int causal, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, causal,
                            static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
