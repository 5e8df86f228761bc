// The device switch of every C entry: the launch runs with `device`, the
// CUDA device that holds its tensors, made current, and the caller's
// device is made current again after, so a launch goes to its tensors'
// device whatever device the calling thread has current.
#pragma once

#include <cuda_runtime.h>

// Runs `launch` (returning a CUDA error code as int) on `device`; returns
// its code, or the error of the switch.
template <typename Launch>
inline int on_device(int device, Launch launch) {
  if (device < 0) return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int ret = launch();
  if (prev != device) cudaSetDevice(prev);
  return ret;
}
