// Steepest-neighbor stencil of DPC's pointer init for Hopper (sm_90a).
//
// Replaces repro/kernels/steepest_neighbor.py::steepest_neighbor, the Pallas
// TPU kernel that computes, for every voxel of an (X, Y, Z) int32 order
// field, the global flat id of the largest-order vertex among the voxel
// itself and its 6/14/18/26 neighbours, self first, strict `>`, candidates
// in the order of stencil.cuh's tables (those of
// repro_torch/core/steepest.py).  Out-of-grid neighbours are skipped.  The
// result does not depend on the TPU's x-slab size.
//
// Bound: device-memory bytes.  The least traffic is one read of the order
// field and one write of the int32 pointers, 8 B/voxel (1.07 GB at 512^3,
// 0.321 ms at 3.35 TB/s); the compares (one per candidate) are far below
// the card's integer rate.  Ids are int32: the wrapper refuses grids of
// 2^31 voxels or more.
//
// Design: a 2.5-D streaming stencil.  A CTA of TY warps (16) owns a tile of
// TY y-rows by 128 z (kTileZ) and marches along x over a run of planes.  It
// keeps a ring of five planes of its tile, each with a one-voxel halo in y
// and z, in shared memory: planes x - 1, x and x + 1 for the voxels of
// plane x, and x + 2, x + 3 in flight (cp.async, a warp a row: 16 bytes a
// lane where the row lies on the 16-byte grid, else 4; out-of-grid halo
// cells are never loaded and never read, since stencil.cuh's bounds tests
// skip those neighbours first).  So each order value comes from device
// memory once, plus the halo rows and the first plane of a run, which
// neighbouring tiles and runs read too (mostly from L2).  A lane owns 4
// z-consecutive voxels: per row of the stencil it reads its 4 values with
// one 16-byte shared load and takes the z - 1 and z + 4 values from its
// neighbour lanes by shuffles.  It folds the
// candidates in table order (stencil::visit_at) over registers, candidate
// by candidate for the 4 voxels, so that it holds self's row and one other
// at a time.  It writes the 4 ids with one 16-byte store where the address
// is 16-byte aligned and the 4 voxels lie in the grid, else one by one.
// The x-runs are as long as it takes to give the card kWaves waves of
// CTAs.
//
// The kernel allocates nothing; the entry point launches on the given
// stream and returns a cudaError_t (0 on success).

#include "resident.cuh"
#include "stencil.cuh"

namespace {

using stencil::Off;

constexpr int kLanes = 32;
constexpr int kPerLane = 4;                  // z-consecutive voxels a lane
constexpr int kTileZ = kLanes * kPerLane;    // z extent of a tile
constexpr int kRow = kTileZ + 8;             // ids a plane row: z0 at col 4
constexpr int kPlanes = 5;                   // ring: x - 1 .. x + 3
constexpr int kWaves = 4;                    // waves of CTAs to aim for
constexpr int kTileRows = 16;                // TY of the shipped launch
constexpr int kMaxRuns = 65535;              // grid.y limit

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Does table C take a candidate off the voxel's own z in stencil row
// (dx, dy)?
template <int C>
__host__ __device__ constexpr bool uses_z(int dx, int dy) {
  for (int k = 0; k < C; ++k) {
    const Off o = stencil::neighbor<C>(k);
    if (o.x == dx && o.y == dy && o.z != 0) return true;
  }
  return false;
}

// Is candidate K's row (outside self's) the last such row before it in
// the table, so that it is still in hand?
template <int C>
__host__ __device__ constexpr bool row_in_hand(int K) {
  const Off o = stencil::neighbor<C>(K);
  for (int k = K - 1; k >= 0; --k) {
    const Off p = stencil::neighbor<C>(k);
    if (p.x != 0 || p.y != 0) return p.x == o.x && p.y == o.y;
  }
  return false;
}

// A lane's values of one stencil row: v[1..4] at its 4 voxels' z, v[0] at
// z - 1 of the first, v[5] at z + 1 of the last.
struct Row {
  int32_t v[kPerLane + 2];
};

// Row `row` of a plane buffer (col 0 at the tile's z0): one 16-byte load a
// lane, and with kZ the z neighbours from the next lanes (the tile's halo
// at the ends).
template <bool kZ>
__device__ __forceinline__ Row load_row(const int32_t* row, int lane) {
  Row r;
  const int4 c = *reinterpret_cast<const int4*>(row + kPerLane * lane);
  r.v[1] = c.x;
  r.v[2] = c.y;
  r.v[3] = c.z;
  r.v[4] = c.w;
  if constexpr (kZ) {
    r.v[0] = __shfl_up_sync(0xffffffffu, c.w, 1);
    r.v[5] = __shfl_down_sync(0xffffffffu, c.x, 1);
    if (lane == 0) r.v[0] = row[-1];
    if (lane == kLanes - 1) r.v[5] = row[kTileZ];
  }
  return r;
}

// A lane's fold over one plane: its voxels, self's row, the row of the
// candidate in hand, and each voxel's best value and id so far.
struct Fold {
  const int32_t* plane[3];  // rows of planes x - 1, x, x + 1 at the warp's y
  int lane;
  stencil::Voxel<int32_t> v[kPerLane];
  Row self, row;
  int32_t best_val[kPerLane], best[kPerLane];
};

// Candidate K of table C for the lane's 4 voxels, through stencil::visit's
// bounds tests; a row is loaded when the candidate before it used another,
// so only one row besides self's is held at a time.
template <int C, int K>
__device__ __forceinline__ void fold_step(Fold& f) {
  constexpr Off o = stencil::neighbor<C>(K);
  constexpr bool own_row = o.x == 0 && o.y == 0;
  if constexpr (!own_row && !row_in_hand<C>(K))
    f.row = load_row<uses_z<C>(o.x, o.y)>(f.plane[o.x + 1] + o.y * kRow,
                                         f.lane);
  const Row& r = own_row ? f.self : f.row;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    auto offer = [&](Off, int32_t j) {
      const int32_t val = r.v[k + 1 + o.z];
      if (val > f.best_val[k]) {
        f.best_val[k] = val;
        f.best[k] = j;
      }
    };
    stencil::visit_at<C, K>(f.v[k], offer);
  }
}

template <int C, int... K>
__device__ __forceinline__ void fold_all(Fold& f,
                                         std::integer_sequence<int, K...>) {
  (fold_step<C, K>(f), ...);  // in table order
}

// Copies the tile of one plane, halo included, into its buffer `buf` (row
// r at buf + r * kRow, z0 at col 4): a warp a row, each lane's 4 z as one
// 16-byte copy where the source row lies on the 16-byte grid there and all
// 4 are in the grid, else cell by cell; lanes 0 and 31 add the z halo.
// `src` is the plane's first id.
template <int TY>
__device__ __forceinline__ void copy_plane(int32_t* buf, const int32_t* src,
                                           int y0, int z0, int Y, int Z) {
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int z = z0 + kPerLane * lane;
  for (int r = w; r < TY + 2; r += TY) {
    const int y = y0 - 1 + r;
    if (y < 0 || y >= Y) continue;
    const int32_t* row = src + y * Z;
    int32_t* dst = buf + r * kRow + 4;
    if (z + kPerLane <= Z &&
        reinterpret_cast<uintptr_t>(row + z0) % 16 == 0) {
      cp_async16(dst + kPerLane * lane, row + z);
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (z + k < Z) cp_async4(dst + kPerLane * lane + k, row + z + k);
    }
    if (lane == 0 && z0 > 0) cp_async4(dst - 1, row + z0 - 1);
    if (lane == kLanes - 1 && z0 + kTileZ < Z)
      cp_async4(dst + kTileZ, row + z0 + kTileZ);
  }
}

template <int C, int TY>
__global__ void __launch_bounds__(kLanes* TY)
    steepest_stream(const int32_t* __restrict__ order,
                    int32_t* __restrict__ out, int X, int Y, int Z,
                    int tiles_z, int xr) {
  constexpr int kPlane = (TY + 2) * kRow;
  extern __shared__ __align__(16) int32_t ring[];
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int z0 = (int)(blockIdx.x % tiles_z) * kTileZ;
  const int y0 = (int)(blockIdx.x / tiles_z) * TY;
  const int x0 = blockIdx.y * xr;
  const int x1 = x0 + xr < X ? x0 + xr : X;
  const int R = Y * Z;
  auto buffer = [&](int p) { return ring + (p - x0 + 1) % kPlanes * kPlane; };
  // plane p of the tile with its halo, or nothing past the grid or the run
  auto load = [&](int p) {
    if (p >= 0 && p < X && p <= x1)
      copy_plane<TY>(buffer(p), order + (size_t)p * R, y0, z0, Y, Z);
    cp_async_commit();  // one group a plane, empty or not
  };
  for (int p = x0 - 1; p < x0 + 3; ++p) load(p);

  const int y = y0 + w;
  const int zb = z0 + kPerLane * lane;
  for (int x = x0; x < x1; ++x) {
    cp_async_wait<1>();  // planes up to x + 1 are in
    __syncthreads();     // ... for every thread; plane x - 2 is free
    load(x + 3);
    if (y >= Y) continue;  // the whole warp
    Fold f;
    for (int d = 0; d < 3; ++d)
      f.plane[d] = buffer(x - 1 + d) + (w + 1) * kRow + 4;
    f.lane = lane;
    f.self = load_row<true>(f.plane[1], lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int z = zb + k;
      f.v[k] = stencil::Voxel<int32_t>{x, y, z, X, Y, Z, R, x * R + y * Z + z};
      f.best_val[k] = f.self.v[k + 1];  // self first
      f.best[k] = f.v[k].i;
    }
    fold_all<C>(f, std::make_integer_sequence<int, C>{});
    const int32_t* best = f.best;
    if (zb < Z) {
      int32_t* o = out + (size_t)x * R + (size_t)y * Z + zb;
      if (zb + kPerLane <= Z && reinterpret_cast<uintptr_t>(o) % 16 == 0) {
        *reinterpret_cast<int4*>(o) = make_int4(best[0], best[1], best[2],
                                                best[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          if (zb + k < Z) o[k] = best[k];
      }
    }
  }
  cp_async_wait<0>();  // no copy may land after the CTA has left
}

// Dynamic shared memory of steepest_stream<., TY>: the ring of planes.
template <int TY>
constexpr size_t ring_bytes() {
  return (size_t)kPlanes * (TY + 2) * kRow * sizeof(int32_t);
}

// Launches the streaming stencil with TY rows a tile and x-runs of `xr`
// planes.
template <int C, int TY>
cudaError_t launch_runs(const int32_t* order, int32_t* out, int X, int Y,
                        int Z, int xr, cudaStream_t stream) {
  const int64_t tiles_z = (Z + kTileZ - 1) / kTileZ;
  const int64_t tiles = tiles_z * ((Y + TY - 1) / TY);
  if (xr < 1 || (X + xr - 1) / xr > kMaxRuns || tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int runs = (X + xr - 1) / xr;
  steepest_stream<C, TY><<<dim3((unsigned)tiles, (unsigned)runs),
                           kLanes * TY, ring_bytes<TY>(), stream>>>(
      order, out, X, Y, Z, (int)tiles_z, xr);
  return cudaGetLastError();
}

// Planes an x-run: as many as it takes for kWaves waves of CTAs over
// `tiles` (y, z) tiles, where `slots` CTAs are resident at once.
inline int run_planes(int X, int64_t tiles, int slots) {
  int64_t runs = ((int64_t)kWaves * slots + tiles - 1) / tiles;
  if (runs > X) runs = X;
  if (runs > kMaxRuns) runs = kMaxRuns;
  if (runs < 1) runs = 1;
  return (int)((X + runs - 1) / runs);
}

// The streaming stencil with x-runs of run_planes (resident.cuh counts the
// resident CTAs).
template <int C, int TY>
cudaError_t launch_stream(const int32_t* order, int32_t* out, int X, int Y,
                          int Z, cudaStream_t stream) {
  static resident::Cache cache;
  const int64_t tiles =
      (int64_t)((Z + kTileZ - 1) / kTileZ) * ((Y + TY - 1) / TY);
  int slots;
  const cudaError_t err = resident::ctas(
      cache, reinterpret_cast<const void*>(steepest_stream<C, TY>),
      kLanes * TY, ring_bytes<TY>(), 0, &slots);
  if (err != cudaSuccess) return err;
  return launch_runs<C, TY>(order, out, X, Y, Z,
                            run_planes(X, tiles, slots), stream);
}

// The streaming stencil for connectivity `conn` (6, 14, 18 or 26).
template <int TY>
cudaError_t launch_conn(int conn, const int32_t* order, int32_t* out, int X,
                        int Y, int Z, cudaStream_t stream) {
  if (X < 0 || Y < 0 || Z < 0) return cudaErrorInvalidValue;
  if ((int64_t)X * Y * Z == 0) return cudaSuccess;
  switch (conn) {
    case 6: return launch_stream<6, TY>(order, out, X, Y, Z, stream);
    case 14: return launch_stream<14, TY>(order, out, X, Y, Z, stream);
    case 18: return launch_stream<18, TY>(order, out, X, Y, Z, stream);
    case 26: return launch_stream<26, TY>(order, out, X, Y, Z, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// order: int32 X*Y*Z row-major, out: int32 X*Y*Z; X*Y*Z < 2^31.
// offsets: `connectivity` (dx, dy, dz) triples, which must be stencil.cuh's
// table for connectivity 6, 14, 18 or 26.  Returns a cudaError_t.
int steepest_neighbor(const void* order, void* out, int X, int Y, int Z,
                      const int* offsets, int connectivity, void* stream) {
  if (!stencil::offsets_match(connectivity, offsets))
    return cudaErrorInvalidValue;
  return launch_conn<kTileRows>(connectivity,
                                static_cast<const int32_t*>(order),
                                static_cast<int32_t*>(out), X, Y, Z,
                                static_cast<cudaStream_t>(stream));
}

const char* steepest_neighbor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
