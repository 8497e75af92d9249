// Device-side launch counters, shared by every kernel library.
//
// A kernel wrapper's Python counter counts the launches its code makes,
// which a CUDA graph replay never runs: a replayed kernel is launched
// from the graph, not by the wrapper.  So each kernel also counts itself
// on the card.  The first thread of its first block adds one to its slot
// as the kernel starts, so a slot holds the launches the device ran:
// eager launches and graph replays alike, and none of the launches a
// capture only records.  One relaxed atomic a launch, off every other
// thread's path.
//
// A library's slots, on the current device, are read by
// `pt_device_launch_counts` (kernels/_build.py `device_launches`).  It
// synchronizes the device first, so it must not run while a graph is
// being captured.
#pragma once

#include <cuda_runtime.h>

constexpr int kLaunchSlots = 4;

__device__ unsigned long long pt_launch_slots[kLaunchSlots];

__device__ __forceinline__ void count_launch(int slot) {
  if ((threadIdx.x | threadIdx.y | threadIdx.z | blockIdx.x | blockIdx.y |
       blockIdx.z) == 0)
    atomicAdd(&pt_launch_slots[slot], 1ull);
}

// Copies the first `n` (at most kLaunchSlots) slots to `out` (host).
extern "C" int pt_device_launch_counts(unsigned long long* out, int n) {
  if (n < 0 || n > kLaunchSlots) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, pt_launch_slots,
                                   n * sizeof(unsigned long long));
}
