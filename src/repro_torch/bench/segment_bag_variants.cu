// A/B variants of the shipped sum EmbeddingBag kernel, built only by
// segment_bag_ab.py.  Never on a path of the port.
//
// The shipped source is included below; a variant is the shipped kernel
// template and launch plan with other choices:
//   * vec: the widest row load a lane makes, 16, 8 or 4 bytes (at D = 32:
//     4, 2 or 1 fp32 rows a warp instruction; 8, 4 or 2 bf16 rows);
//   * rows: ids a group gathers, and rows it has in flight, before its adds
//     (4, 8 or 16; 8 or 16 with the L2 policies off);
//   * wshift: bags a warp as a shift (0: one bag, 1: two, 2: four), or -1
//     for the shipped rule;
//   * hint: the L2 policies (table rows evict_last, ids and output
//     evict_first) on, or every access at evict_normal, the default.
// Entry points: segment_bag_variant_{f32,bf16}_i32, the shipped entry
// points' arguments followed by vec, rows, wshift and hint; an unbuilt
// combination, or a vec wider than the shipped plan allows, returns
// cudaErrorInvalidValue.

#include "../kernels/csrc/segment_bag.cu"

namespace {

// The shipped plan with a narrower row load (more lanes a row, as many
// groups a bag as still fit in a warp) and `wshift` bags a warp.
template <typename T, int ROWS, bool HINT>
int launch(const void* table, const void* ids, void* out, int64_t V, int D,
           int64_t B, int L, int vec, int wshift, cudaStream_t stream) {
  using segment_bag::bag_kernel;
  using segment_bag::kThreads;
  if (B <= 0 || D <= 0 || L < 0) return cudaErrorInvalidValue;
  segment_bag::Plan p = segment_bag::plan(table, ids, out, sizeof(T),
                                          sizeof(int32_t), D, B, L, ROWS);
  if (vec > p.vec) return cudaErrorInvalidValue;
  p.vec = vec;
  p.chunks = (int)((int64_t)D * sizeof(T) / vec);
  const int g = segment_bag::log2_ceil(p.chunks);
  p.gshift = g < 5 ? g : 5;
  p.qshift = p.qshift < 5 - p.gshift ? p.qshift : 5 - p.gshift;
  if (wshift >= 0)
    p.qshift = 5 - p.gshift - wshift > 0 ? 5 - p.gshift - wshift : 0;
  p.blocks = segment_bag::blocks(B, p.gshift, p.qshift);
  const T* t = static_cast<const T*>(table);
  const int32_t* i = static_cast<const int32_t*>(ids);
  T* o = static_cast<T*>(out);
#define SEGMENT_BAG_VARIANT_LAUNCH(VEC)                                      \
  bag_kernel<T, int32_t, VEC, ROWS, HINT><<<(unsigned)p.blocks, kThreads, 0, \
                                            stream>>>(                       \
      t, i, o, V, p.chunks, p.gshift, p.qshift, B, L, p.ids_vec)
  switch (vec) {
    case 16: SEGMENT_BAG_VARIANT_LAUNCH(16); break;
    case 8: SEGMENT_BAG_VARIANT_LAUNCH(8); break;
    case 4: SEGMENT_BAG_VARIANT_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef SEGMENT_BAG_VARIANT_LAUNCH
  return cudaGetLastError();
}

template <typename T>
int variant(const void* table, const void* ids, void* out, int64_t V, int D,
            int64_t B, int L, int vec, int rows, int wshift, int hint,
            cudaStream_t stream) {
#define SEGMENT_BAG_VARIANT(ROWS, HINT)                                   \
  if (rows == ROWS && hint == HINT)                                       \
    return launch<T, ROWS, HINT>(table, ids, out, V, D, B, L, vec, wshift, \
                                 stream)
  SEGMENT_BAG_VARIANT(4, 1);
  SEGMENT_BAG_VARIANT(8, 1);
  SEGMENT_BAG_VARIANT(16, 1);
  SEGMENT_BAG_VARIANT(8, 0);
  SEGMENT_BAG_VARIANT(16, 0);
#undef SEGMENT_BAG_VARIANT
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int segment_bag_variant_f32_i32(const void* table, const void* ids, void* out,
                                int64_t V, int D, int64_t B, int L, int vec,
                                int rows, int wshift, int hint,
                                void* stream) {
  return variant<float>(table, ids, out, V, D, B, L, vec, rows, wshift, hint,
                        static_cast<cudaStream_t>(stream));
}
int segment_bag_variant_bf16_i32(const void* table, const void* ids,
                                 void* out, int64_t V, int D, int64_t B,
                                 int L, int vec, int rows, int wshift,
                                 int hint, void* stream) {
  return variant<__nv_bfloat16>(table, ids, out, V, D, B, L, vec, rows,
                                wshift, hint,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
