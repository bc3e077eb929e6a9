// A/B variants of the two shipped pointer kernels, built only by
// pointer_kernels_ab.py.  Never on a path of the port.
//
// The shipped sources are included below.  Entries:
//   * bpc_ring_variant_i32: block_pathcompress's shared configuration with
//     `stages` tile stages, rounds in place or ping-pong (`pingpong`) and
//     `ept` stage positions a thread (4, 8, 16 or 32: 1024, 512, 256 or 128
//     threads at block 4096), and with fixed = 0 the thread count a runtime
//     value even at 256 (8 or 16 positions a thread); the shipped kernel
//     and its helpers, only the launch choice differs.
//   * bpc_chunks_variant_i32: the same ring with 16-byte chunks a thread
//     (`cpt` of them: the chunk t, t + T, ...), 16-byte shared loads and
//     stores and 16-byte stores to device memory where `out` has d's offset
//     modulo 16.  A warp's gathers of nearby pointers then fall four to a
//     bank.
//   * steepest_variant: steepest_neighbor's streaming stencil with `ty`
//     rows a tile (4, 8 or 16), x-runs of `xr` planes (0: the shipped
//     rule, kWaves waves of CTAs), and with wide = 0 (16 rows, the shipped
//     rule only) steepest_cells: the shipped kernel with the planes copied
//     cell by cell, 4 bytes a thread (the first design), in place of a warp
//     a row.
//   * bpc_requery_i32, steepest_requery: the shipped C entries after the
//     device queries that resident.cuh keeps (device, SM count, occupancy),
//     made again as every call once made them: what the cache saves on the
//     host.

#include "../kernels/csrc/block_pathcompress.cu"
#include "../kernels/csrc/steepest_neighbor.cu"

namespace {

// steepest_stream<C, kTileRows> with its first plane copy: cell by cell, 4
// bytes a thread over the whole plane tile (rows straddle warps).
template <int C>
__global__ void __launch_bounds__(kLanes* kTileRows)
    steepest_cells(const int32_t* __restrict__ order,
                   int32_t* __restrict__ out, int X, int Y, int Z,
                   int tiles_z, int xr) {
  constexpr int TY = kTileRows;
  constexpr int kPlane = (TY + 2) * kRow;
  constexpr int kCells = (TY + 2) * (kTileZ + 2);
  extern __shared__ __align__(16) int32_t ring[];
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int z0 = (int)(blockIdx.x % tiles_z) * kTileZ;
  const int y0 = (int)(blockIdx.x / tiles_z) * TY;
  const int x0 = blockIdx.y * xr;
  const int x1 = x0 + xr < X ? x0 + xr : X;
  const int R = Y * Z;
  auto buffer = [&](int p) { return ring + (p - x0 + 1) % kPlanes * kPlane; };
  auto load = [&](int p) {
    if (p >= 0 && p < X && p <= x1) {
      int32_t* buf = buffer(p);
      const int32_t* src = order + (size_t)p * R;
      for (int e = threadIdx.x; e < kCells; e += kLanes * TY) {
        const int r = e / (kTileZ + 2), c = e % (kTileZ + 2);
        const int y = y0 - 1 + r, z = z0 - 1 + c;
        if (y >= 0 && y < Y && z >= 0 && z < Z)
          cp_async4(buf + r * kRow + 3 + c, src + y * Z + z);
      }
    }
    cp_async_commit();
  };
  for (int p = x0 - 1; p < x0 + 3; ++p) load(p);

  const int y = y0 + w;
  const int zb = z0 + kPerLane * lane;
  for (int x = x0; x < x1; ++x) {
    cp_async_wait<1>();
    __syncthreads();
    load(x + 3);
    if (y >= Y) continue;
    Fold f;
    for (int d = 0; d < 3; ++d)
      f.plane[d] = buffer(x - 1 + d) + (w + 1) * kRow + 4;
    f.lane = lane;
    f.self = load_row<true>(f.plane[1], lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int z = zb + k;
      f.v[k] = stencil::Voxel<int32_t>{x, y, z, X, Y, Z, R, x * R + y * Z + z};
      f.best_val[k] = f.self.v[k + 1];
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
  cp_async_wait<0>();
}

template <int C>
cudaError_t launch_cells(const int32_t* order, int32_t* out, int X, int Y,
                         int Z, cudaStream_t stream) {
  static resident::Cache cache;
  const int64_t tiles_z = (Z + kTileZ - 1) / kTileZ;
  const int64_t tiles = tiles_z * ((Y + kTileRows - 1) / kTileRows);
  int slots;
  const cudaError_t err = resident::ctas(
      cache, reinterpret_cast<const void*>(steepest_cells<C>),
      kLanes * kTileRows, ring_bytes<kTileRows>(), 0, &slots);
  if (err != cudaSuccess) return err;
  const int xr = run_planes(X, tiles, slots);
  steepest_cells<C><<<dim3((unsigned)tiles, (unsigned)((X + xr - 1) / xr)),
                      kLanes * kTileRows, ring_bytes<kTileRows>(), stream>>>(
      order, out, X, Y, Z, (int)tiles_z, xr);
  return cudaGetLastError();
}

// The shipped ring with the thread count a runtime value.
template <int EPT>
cudaError_t launch_ring_runtime(const int32_t* d, int32_t* out, int64_t n,
                                int block, int rounds, int stages,
                                int pingpong, cudaStream_t stream) {
  const int threads = ring_threads(tile_positions(d, block), EPT);
  const int ids = threads * EPT;
  if (stages < 1 || stages > kMaxStages || threads > kMaxThreads ||
      (pingpong != 0 && pingpong != 1) ||
      kBarrierBytes + (size_t)(stages + pingpong) * ids * 4 > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  return launch_ring_ept<int32_t, EPT, 0>(d, out, n, block, rounds, stages,
                                          pingpong, ids, threads, stream);
}

// One 16-byte chunk of ids, for vector loads and stores.
template <typename Id>
union Chunk {
  int4 v;
  Id id[16 / sizeof(Id)];
};

template <typename Id, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    tile_rounds_chunks(const Id* __restrict__ d, Id* __restrict__ out,
                       int64_t n, int block, int rounds, int stages,
                       int stage_ids, int64_t tiles, int vec_store) {
  constexpr int kVec = Tile<Id>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Id* ring = reinterpret_cast<Id*>(smem + kBarrierBytes);
  const int64_t G = gridDim.x;
  const int64_t mine = (tiles - blockIdx.x + G - 1) / G;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages && s < mine; ++s)
      fill_stage(d, ring + (size_t)s * stage_ids, bar + s,
                 Tile<Id>(d, blockIdx.x + s * G, block, n));
  }
  __syncthreads();

  for (int64_t j = 0; j < mine; ++j) {
    const int s = (int)(j % stages);
    Id* st = ring + (size_t)s * stage_ids;
    const Tile<Id> g(d, blockIdx.x + j * G, block, n);
    const int chunks = g.ids / kVec, lo = g.lo / kVec, hi = g.hi / kVec;
    mbar_wait(bar + s, (uint32_t)(j / stages) & 1);
    if (lo > 0 || hi < chunks) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (c < chunks && (c < lo || c >= hi)) {
          for (int e = 0; e < kVec; ++e) {
            const int i = c * kVec - g.shift + e;
            if (i >= 0 && i < g.valid) st[c * kVec + e] = d[g.base + i];
          }
          fence_proxy_async();
        }
      }
      __syncthreads();
    }
    Chunk<Id> nv[CPT];
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (c < chunks) {
          Chunk<Id> cur;
          cur.v = *reinterpret_cast<const int4*>(st + c * kVec);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int i = c * kVec - g.shift + e;
            const Id p = i >= 0 && i < g.valid ? cur.id[e] : (Id)-1;
            Id q = p;
            if (p >= 0 && (int64_t)p >= g.base &&
                (int64_t)p - g.base < block) {
              const int to = (int)((int64_t)p - g.base);
              q = to < g.valid ? st[to + g.shift] : (Id)-1;
            }
            nv[k].id[e] = q;
          }
        }
      }
      __syncthreads();
      if (r + 1 == rounds) break;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (c < chunks) *reinterpret_cast<int4*>(st + c * kVec) = nv[k].v;
      }
      fence_proxy_async();
      __syncthreads();
    }
    if (threadIdx.x == 0 && j + stages < mine)
      fill_stage(d, st, bar + s,
                 Tile<Id>(d, blockIdx.x + (j + stages) * G, block, n));
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c >= chunks) continue;
      Id* o = out + g.base + c * kVec - g.shift;
      if (vec_store && c >= lo && c < hi) {
        *reinterpret_cast<int4*>(o) = nv[k].v;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int i = c * kVec - g.shift + e;
          if (i >= 0 && i < g.valid) o[e] = nv[k].id[e];
        }
      }
    }
  }
}

template <int CPT>
int launch_chunks(const int32_t* d, int32_t* out, int64_t n, int block,
                  int rounds, int stages, cudaStream_t stream) {
  const int ids = tile_positions(d, block);
  const int threads = ((ids / 4 + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t bytes = kBarrierBytes + (size_t)stages * ids * 4;
  if (stages < 1 || stages > kMaxStages || threads > kMaxThreads ||
      bytes > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  static resident::Cache cache;
  int slots;
  const cudaError_t err = resident::ctas(
      cache, reinterpret_cast<const void*>(tile_rounds_chunks<int32_t, CPT>),
      threads, bytes, (int)kMaxSharedBytes, &slots);
  if (err != cudaSuccess) return err;
  if (slots < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (n + block - 1) / block;
  const int64_t grid = tiles < slots ? tiles : slots;
  const int vec_store =
      (reinterpret_cast<uintptr_t>(out) - reinterpret_cast<uintptr_t>(d)) %
          16 ==
      0;
  tile_rounds_chunks<int32_t, CPT><<<(unsigned)grid, threads, bytes,
                                     stream>>>(d, out, n, block, rounds,
                                               stages, ids, tiles, vec_store);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d, out: n int32 ids; rounds >= 1; two tiles of `block` ids within
// 227 KB.  Returns a cudaError_t.
int bpc_ring_variant_i32(const void* d, void* out, int64_t n, int64_t block,
                         int rounds, int stages, int pingpong, int ept,
                         int fixed, void* stream) {
  if (n <= 0 || rounds < 1 || block < 1 ||
      2 * (size_t)block * sizeof(int32_t) > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const int32_t* src = static_cast<const int32_t*>(d);
  int32_t* dst = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed)
    return launch_ring<int32_t>(src, dst, n, (int)block, rounds, stages,
                                pingpong, ept, s);
  switch (ept) {
    case 8: return launch_ring_runtime<8>(src, dst, n, (int)block, rounds,
                                          stages, pingpong, s);
    case 16: return launch_ring_runtime<16>(src, dst, n, (int)block, rounds,
                                            stages, pingpong, s);
    default: return cudaErrorInvalidValue;
  }
}

int bpc_chunks_variant_i32(const void* d, void* out, int64_t n,
                           int64_t block, int rounds, int stages, int cpt,
                           void* stream) {
  if (n <= 0 || rounds < 1 || block < 1 ||
      2 * (size_t)block * sizeof(int32_t) > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const int32_t* src = static_cast<const int32_t*>(d);
  int32_t* dst = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt) {
    case 2: return launch_chunks<2>(src, dst, n, (int)block, rounds, stages, s);
    case 4: return launch_chunks<4>(src, dst, n, (int)block, rounds, stages, s);
    default: return cudaErrorInvalidValue;
  }
}

// order, out: int32 X*Y*Z; offsets as steepest_neighbor takes them.
int steepest_variant(const void* order, void* out, int X, int Y, int Z,
                     const int* offsets, int connectivity, int ty, int xr,
                     int wide, void* stream) {
  if (!stencil::offsets_match(connectivity, offsets) || X < 1 || Y < 1 ||
      Z < 1)
    return cudaErrorInvalidValue;
  const int32_t* src = static_cast<const int32_t*>(order);
  int32_t* dst = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEEPEST_CONN(LAUNCH)                                               \
  switch (connectivity) {                                                   \
    case 6: return LAUNCH(6);                                               \
    case 14: return LAUNCH(14);                                             \
    case 18: return LAUNCH(18);                                             \
    case 26: return LAUNCH(26);                                             \
    default: return cudaErrorInvalidValue;                                  \
  }
#define CELLS(C) launch_cells<C>(src, dst, X, Y, Z, s)
#define RUNS(C) launch_runs<C, kTileRows>(src, dst, X, Y, Z, xr, s)
  if (!wide) {
    if (ty != kTileRows || xr != 0) return cudaErrorInvalidValue;
    STEEPEST_CONN(CELLS)
  }
  if (xr > 0) {
    if (ty != kTileRows) return cudaErrorInvalidValue;
    STEEPEST_CONN(RUNS)
  }
#undef RUNS
#undef CELLS
#undef STEEPEST_CONN
  switch (ty) {
    case 4: return launch_conn<4>(connectivity, src, dst, X, Y, Z, s);
    case 8: return launch_conn<8>(connectivity, src, dst, X, Y, Z, s);
    case 16: return launch_conn<16>(connectivity, src, dst, X, Y, Z, s);
    default: return cudaErrorInvalidValue;
  }
}

// As block_pathcompress_i32 in the shared configuration at block 4096
// (256 threads, 2 stages and a spare of 16 KB).
int bpc_requery_i32(const void* d, void* out, int64_t n, int rounds,
                    void* stream) {
  const void* kernel = reinterpret_cast<const void*>(
      tile_rounds_ring<int32_t, 16, kTargetThreads>);
  int device, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kTargetThreads,
           kBarrierBytes + 3 * 4096 * sizeof(int32_t))) != cudaSuccess)
    return err;
  return block_pathcompress_i32(d, out, nullptr, n, 4096, rounds, 1, stream);
}

// As steepest_neighbor at connectivity 6.
int steepest_requery(const void* order, void* out, int X, int Y, int Z,
                     const int* offsets, void* stream) {
  const void* kernel =
      reinterpret_cast<const void*>(steepest_stream<6, kTileRows>);
  int device, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kLanes * kTileRows, ring_bytes<kTileRows>())) !=
          cudaSuccess)
    return err;
  return steepest_neighbor(order, out, X, Y, Z, offsets, 6, stream);
}

}  // extern "C"
