// Dynamic shared memory past the default.  A block may take 48 KiB of
// shared memory in all, static and dynamic together, unless its kernel has
// opted in to more, up to the device's opt-in limit (227 KiB a block on
// the H100).  The opt-in is a function attribute, set by a host call; a
// launch that needs it and finds it unset fails.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace launch {

constexpr int kMaxDevices = 64;

// One kernel's dynamic shared-memory limit on each device, as a static of
// its launcher.  The first call on a device opts the kernel in to all the
// device allows beside the kernel's static shared memory, and keeps that
// limit; a later call reads it, so a launch costs no attribute call.
class DynSmem {
 public:
  // The most dynamic shared memory a block of `kernel` may take on the
  // current device: >= 0 bytes, or minus a CUDA error.
  template <class Kernel>
  long long limit(Kernel kernel) {
    int device;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return -(long long)e;
    if (device < 0 || device >= kMaxDevices) {
      return -(long long)cudaErrorInvalidDevice;
    }
    const long long known = limit_[device].load(std::memory_order_acquire);
    if (known > 0) return known;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return -(long long)e;
    int optin;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
    if (e != cudaSuccess) return -(long long)e;
    const long long bytes = (long long)optin - (long long)attr.sharedSizeBytes;
    if (bytes <= 0) return -(long long)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return -(long long)e;
    limit_[device].store(bytes, std::memory_order_release);
    return bytes;
  }

  // cudaSuccess where a block of `kernel` may take `smem` bytes of dynamic
  // shared memory on the current device, the error otherwise.
  template <class Kernel>
  cudaError_t fit(Kernel kernel, size_t smem) {
    const long long lim = limit(kernel);
    if (lim < 0) return (cudaError_t)(-lim);
    return (long long)smem <= lim ? cudaSuccess : cudaErrorInvalidValue;
  }

 private:
  std::atomic<long long> limit_[kMaxDevices] = {};
};

}  // namespace launch
