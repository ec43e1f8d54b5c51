// DeviceScope, shared by the kernel libraries of this directory: each C entry
// point makes `device` current for its call and gives the caller's device
// back on return, so a launch on another card does not move the calling
// thread.  ops/cuda_lib.py hashes this header into the build key of every
// library that includes it.
#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
