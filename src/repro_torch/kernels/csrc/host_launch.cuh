// Host-side launch helpers shared by every kernel source: the device guard
// of each C entry point and the opt-in to more than 48 KB of dynamic
// shared memory (tree_gather.cu, flash_attention.cu, moe_gmm.cu).
//
// A launch runs on the calling thread's current card, whatever stream it is
// given, so each C entry point takes the card of its operands and makes it
// current for the launch (`DeviceGuard`), then restores the thread's card.
// When the card is already current, which is every launch on one card, the
// guard costs one cudaGetDevice.
//
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize)
// applies to the current card, so a grant is kept per kernel and card and
// made once for the largest size asked so far.  A refused grant is not
// remembered: it is cleared from the thread's last CUDA error (or the
// launch's own cudaGetLastError() would report it again, and so would the
// next launch on that thread) and returned, and the next launch asks again.
#pragma once

#include <cuda_runtime.h>

namespace host_launch {

constexpr int kMaxDevices = 64;

// Makes `device` the calling thread's current card for the guard's life.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    error_ = cudaGetDevice(&previous_);
    if (error_ == cudaSuccess && previous_ != device) {
      error_ = cudaSetDevice(device);
      switched_ = error_ == cudaSuccess;
    }
    if (error_ != cudaSuccess) cudaGetLastError();
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return error_; }

 private:
  int previous_ = 0;
  bool switched_ = false;
  cudaError_t error_ = cudaSuccess;
};

// `granted` is the caller's per-card array of kMaxDevices byte counts
// granted so far (one static array per kernel instance).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int* granted, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem_bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err == cudaSuccess) {
    granted[dev] = smem_bytes;
  } else {
    cudaGetLastError();
  }
  return err;
}

}  // namespace host_launch
