// A scoped switch of the calling host thread's current CUDA device.
//
// Every C entry point of the library takes the device of its tensors and
// launches there.  The CUDA runtime keeps one current device per host
// thread, and the caller's code in that thread relies on it: PyTorch
// resolves an index-less "cuda" to it.  An entry point that set the device
// and returned would leave the thread's later index-less allocations on the
// kernel's card, which matters as soon as one thread drives several cards
// (the scenario shards of the device engine).  DeviceGuard sets the device
// for the scope of an entry point and restores the caller's on every
// return, the error paths included.
#pragma once

#include <cuda_runtime.h>

namespace {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or why the current device could not be read or set
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace
