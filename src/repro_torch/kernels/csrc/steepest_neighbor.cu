// Steepest-neighbor stencil of DPC's pointer init for Hopper (sm_90a).
//
// Replaces repro/kernels/steepest_neighbor.py::steepest_neighbor, the Pallas
// TPU kernel that computes, for every voxel of an (X, Y, Z) int32 order
// field, the global flat id of the largest-order vertex among the voxel
// itself and its 6/14/18/26 neighbours, self first, strict `>`.  The
// stencil is stencil.cuh's kSteepest init, the one fused_local_phase.cu
// runs before its doubling rounds.  The result does not depend on the TPU's
// x-slab size, so the kernel is one global stencil.
//
// Bound: device-memory bytes.  The least traffic is one read of the order
// field and one write of the int32 pointers, 8 B/voxel (1.07 GB at 512^3,
// 0.321 ms at 3.35 TB/s); the compares (one per candidate) are far below
// the card's integer rate.  Ids are int32: the wrapper refuses grids of
// 2^31 voxels or more.
//
// The kernel allocates nothing; the entry point launches on the given
// stream and returns a cudaError_t (0 on success).

#include "stencil.cuh"

extern "C" {

// order: int32 X*Y*Z row-major, out: int32 X*Y*Z; X*Y*Z < 2^31.
// offsets: `connectivity` (dx, dy, dz) triples, which must be stencil.cuh's
// table for connectivity 6, 14, 18 or 26.  Returns a cudaError_t.
int steepest_neighbor(const void* order, void* out, int X, int Y, int Z,
                      const int* offsets, int connectivity, void* stream) {
  if (!stencil::offsets_match(connectivity, offsets))
    return cudaErrorInvalidValue;
  return stencil::launch_init<stencil::kSteepest, int32_t>(
      connectivity, order, nullptr, static_cast<int32_t*>(out), X, Y, Z,
      static_cast<cudaStream_t>(stream));
}

const char* steepest_neighbor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
