// Resident CTAs of a kernel on the current device: the SMs times the CTAs
// an SM holds at one launch shape, which sizes a persistent grid
// (block_pathcompress.cu) or the waves of one (steepest_neighbor.cu).
// The device queries cost host time on every launch, so the answer is kept
// a process, device and kernel, for the last launch shape asked for.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace resident {

constexpr int kDevices = 64;

// One kernel's answers: a slot a device, the launch shape and its CTAs
// packed as ((threads << 18 | bytes) << 1 | 1) << 20 | ctas; 0 is empty.
// A `static Cache` starts zeroed.
struct Cache {
  std::atomic<uint64_t> slot[kDevices];
};

// *ctas = resident CTAs of `kernel` at `threads` threads and `bytes` of
// dynamic shared memory on the current device.  With max_shared > 0, the
// kernel may take that much dynamic shared memory; it is set on the first
// query of a device (and again whenever the launch shape changes).
inline cudaError_t ctas(Cache& cache, const void* kernel, int threads,
                        size_t bytes, int max_shared, int* ctas) {
  int device;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  const bool packs = threads < (1 << 11) && bytes < (1u << 18);
  const uint64_t key = ((uint64_t)threads << 18 | bytes) << 1 | 1;
  std::atomic<uint64_t>* slot =
      device < kDevices && packs ? &cache.slot[device] : nullptr;
  if (slot != nullptr) {
    const uint64_t v = slot->load(std::memory_order_relaxed);
    if (v >> 20 == key) {
      *ctas = (int)(v & 0xfffff);
      return cudaSuccess;
    }
  }
  if (max_shared > 0 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_shared)) != cudaSuccess)
    return err;
  int sms, per_sm;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, bytes)) != cudaSuccess)
    return err;
  *ctas = per_sm * sms;
  if (slot != nullptr && *ctas < (1 << 20))
    slot->store(key << 20 | (uint64_t)*ctas, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace resident
