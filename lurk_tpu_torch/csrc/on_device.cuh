// The device switch of the kernels' C entry points (poseidon2.cu,
// quotient.cu, open.cu).

#pragma once

#include <cuda_runtime.h>

namespace lurk {

// Runs body() with `device` current and sets the caller's device back
// before returning: the runtime's current device belongs to the calling
// host thread, and PyTorch keeps its own record of it, so an entry point
// that left another device current would put the two out of step.
// Returns body()'s cudaError_t, or the first error of the device switch.
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int res = body();
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (res == 0 && err != cudaSuccess) res = static_cast<int>(err);
  }
  return res;
}

}  // namespace lurk
