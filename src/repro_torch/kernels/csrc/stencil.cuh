// Pointer-init stencil of DPC on an (X, Y, Z) grid: the offset tables and
// their compile-time fold, shared by fused_local_phase.cu (whose init runs
// init_kernel below) and steepest_neighbor.cu (whose streaming kernel folds
// over values it holds in a tile, through `visit_at`).
//
// For every voxel, one of two candidates' rules over the voxel itself and
// its 6/14/18/26 neighbours:
//   * kSteepest (int32 order field): the flat id of the largest order.  Self
//     is the first candidate and a neighbour replaces the best only if
//     strictly greater (jnp.argmax's first-max-wins over the stacked
//     candidates), so ties keep the earlier candidate in the order of
//     repro_torch/core/steepest.py's offset tables.
//   * kMaskedMax (bool mask): the largest masked flat id, -1 for an
//     unmasked voxel.
// An optional self_mask makes a voxel with a pointer point at itself.
// Out-of-grid neighbours are skipped: the TPU kernels' inert fill (int32
// min, or unmasked) never wins.
//
// The kernel is templated on the connectivity and walks the offsets in a
// compile-time fold, so every offset and every bounds test is a constant
// (no offset table in a stack frame).  A block is 32 z-consecutive voxels
// by 4 y-rows and loops over x, so no thread divides a flat id; neighbour
// rows are re-read from L1/L2, not from device memory.
//
// The offset order decides ties, so the entry points take the Python
// tables too and refuse any that differ from these (`offsets_match`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace stencil {

struct Off {
  int x, y, z;
};

// The offset tables of repro_torch/core/steepest.py, in the same order.
__host__ __device__ constexpr Off offset6or14(int k) {
  const int t[14][3] = {{1, 0, 0},  {-1, 0, 0},  {0, 1, 0},   {0, -1, 0},
                        {0, 0, 1},  {0, 0, -1},  {1, 1, 0},   {-1, -1, 0},
                        {0, 1, 1},  {0, -1, -1}, {1, 0, 1},   {-1, 0, -1},
                        {1, 1, 1},  {-1, -1, -1}};
  return Off{t[k][0], t[k][1], t[k][2]};
}

// 26: every nonzero (i, j, k) in {-1, 0, 1}^3, i slowest; 18: the subset
// with |i| + |j| + |k| <= 2, in the same order.
__host__ __device__ constexpr Off offset18or26(int conn, int k) {
  int seen = 0;
  for (int c = 0; c < 27; ++c) {
    const int x = c / 9 - 1, y = c / 3 % 3 - 1, z = c % 3 - 1;
    const int a = (x < 0 ? -x : x) + (y < 0 ? -y : y) + (z < 0 ? -z : z);
    if (a == 0 || (conn == 18 && a == 3)) continue;
    if (seen == k) return Off{x, y, z};
    ++seen;
  }
  return Off{0, 0, 0};
}

template <int C>
__host__ __device__ constexpr Off neighbor(int k) {
  return (C == 6 || C == 14) ? offset6or14(k) : offset18or26(C, k);
}

static_assert(neighbor<14>(6).x == 1 && neighbor<14>(6).y == 1 &&
                  neighbor<14>(13).z == -1,
              "14-table order");
static_assert(neighbor<26>(0).x == -1 && neighbor<26>(0).y == -1 &&
                  neighbor<26>(0).z == -1 && neighbor<26>(13).x == 0 &&
                  neighbor<26>(13).y == 0 && neighbor<26>(13).z == 1,
              "26-table order");
static_assert(neighbor<18>(0).x == -1 && neighbor<18>(0).y == -1 &&
                  neighbor<18>(0).z == 0 && neighbor<18>(17).x == 1 &&
                  neighbor<18>(17).y == 1 && neighbor<18>(17).z == 0,
              "18-table order");

template <int C>
bool same_table(const int* offsets) {
  for (int k = 0; k < C; ++k) {
    const Off o = neighbor<C>(k);
    if (offsets[3 * k] != o.x || offsets[3 * k + 1] != o.y ||
        offsets[3 * k + 2] != o.z)
      return false;
  }
  return true;
}

// True if `offsets` (conn (dx, dy, dz) triples) is this file's table for
// connectivity `conn`, which must be 6, 14, 18 or 26.
inline bool offsets_match(int conn, const int* offsets) {
  switch (conn) {
    case 6: return same_table<6>(offsets);
    case 14: return same_table<14>(offsets);
    case 18: return same_table<18>(offsets);
    case 26: return same_table<26>(offsets);
    default: return false;
  }
}

enum Mode { kSteepest = 0, kMaskedMax = 1 };

template <typename Id>
struct Voxel {
  int x, y, z, X, Y, Z;
  Id R, i;  // R = Y * Z; i = the flat id
};

template <int C, int K, typename Id, typename Offer>
__device__ __forceinline__ void visit(const Voxel<Id>& v, Offer& offer) {
  constexpr Off o = neighbor<C>(K);
  bool in = true;
  if constexpr (o.x > 0) in = in && v.x + 1 < v.X;
  if constexpr (o.x < 0) in = in && v.x > 0;
  if constexpr (o.y > 0) in = in && v.y + 1 < v.Y;
  if constexpr (o.y < 0) in = in && v.y > 0;
  if constexpr (o.z > 0) in = in && v.z + 1 < v.Z;
  if constexpr (o.z < 0) in = in && v.z > 0;
  if (in) offer(v.i + (Id)o.x * v.R + (Id)o.y * v.Z + o.z);
}

template <int C, typename Id, typename Offer, int... K>
__device__ __forceinline__ void visit_all(const Voxel<Id>& v, Offer& offer,
                                          std::integer_sequence<int, K...>) {
  (visit<C, K>(v, offer), ...);  // in table order
}

// visit for a kernel that holds the candidates' values itself
// (steepest_neighbor.cu's tiles): offer(o, j) gets neighbour K's offset o,
// a constant once inlined, beside its flat id j, if visit's bounds tests
// let it through.
template <int C, int K, typename Id, typename Offer>
__device__ __forceinline__ void visit_at(const Voxel<Id>& v, Offer& offer) {
  auto at = [&](Id j) { offer(neighbor<C>(K), j); };
  visit<C, K>(v, at);
}

constexpr int kBlockZ = 32;
constexpr int kBlockY = 4;
constexpr int kMaxGridYZ = 65535;

template <int C, int M, typename Id>
__global__ void __launch_bounds__(kBlockZ* kBlockY)
    init_kernel(const void* __restrict__ field,
                const uint8_t* __restrict__ self_mask, Id* __restrict__ out,
                int X, int Y, int Z) {
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  if (z >= Z) return;
  const Id R = (Id)Y * Z;
  for (int x = blockIdx.z; x < X; x += gridDim.z) {
    for (int y = blockIdx.y * kBlockY + threadIdx.y; y < Y;
         y += gridDim.y * kBlockY) {
      const Voxel<Id> v{x, y, z, X, Y, Z, R, (Id)x * R + (Id)y * Z + z};
      Id best;
      if constexpr (M == kSteepest) {
        const int32_t* order = static_cast<const int32_t*>(field);
        int32_t best_val = __ldg(order + v.i);
        best = v.i;
        auto offer = [&](Id j) {
          const int32_t val = __ldg(order + j);
          if (val > best_val) {
            best_val = val;
            best = j;
          }
        };
        visit_all<C>(v, offer, std::make_integer_sequence<int, C>{});
      } else {
        const uint8_t* mask = static_cast<const uint8_t*>(field);
        best = -1;
        if (__ldg(mask + v.i)) {
          best = v.i;
          auto offer = [&](Id j) {
            if (__ldg(mask + j) && j > best) best = j;
          };
          visit_all<C>(v, offer, std::make_integer_sequence<int, C>{});
        }
      }
      if (self_mask != nullptr && best >= 0 && self_mask[v.i]) best = v.i;
      out[v.i] = best;
    }
  }
}

// Launches the init of mode M for connectivity `conn` (6, 14, 18 or 26) on
// `stream`.  self_mask may be NULL.  Returns a cudaError_t.
template <int M, typename Id>
cudaError_t launch_init(int conn, const void* field, const uint8_t* self_mask,
                        Id* out, int X, int Y, int Z, cudaStream_t stream) {
  if (X < 0 || Y < 0 || Z < 0) return cudaErrorInvalidValue;
  if ((int64_t)X * Y * Z == 0) return cudaSuccess;
  const int gy = (Y + kBlockY - 1) / kBlockY;
  const dim3 grid((Z + kBlockZ - 1) / kBlockZ,
                  gy < kMaxGridYZ ? gy : kMaxGridYZ,
                  X < kMaxGridYZ ? X : kMaxGridYZ);
  const dim3 block(kBlockZ, kBlockY);
  switch (conn) {
    case 6:
      init_kernel<6, M, Id><<<grid, block, 0, stream>>>(field, self_mask, out,
                                                        X, Y, Z);
      break;
    case 14:
      init_kernel<14, M, Id><<<grid, block, 0, stream>>>(field, self_mask,
                                                         out, X, Y, Z);
      break;
    case 18:
      init_kernel<18, M, Id><<<grid, block, 0, stream>>>(field, self_mask,
                                                         out, X, Y, Z);
      break;
    case 26:
      init_kernel<26, M, Id><<<grid, block, 0, stream>>>(field, self_mask,
                                                         out, X, Y, Z);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace stencil
