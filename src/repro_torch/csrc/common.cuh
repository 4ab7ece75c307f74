// Shared by every kernel library: a plain C interface loaded with ctypes.
// Each entry point launches on the card and stream it is given (the card
// that holds its tensors and PyTorch's current stream there), allocates
// nothing, does not synchronise, and returns cudaGetLastError() so that the
// Python wrapper can raise on a launch the runtime refused.
#pragma once
#include <cuda_runtime.h>

#define KEY_SENTINEL (-1)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Makes `device` current for one entry point and restores the caller's card
// when it goes out of scope: a kernel launches on the current card, and the
// stream it is given belongs to the card that holds its tensors. Costs one
// cudaGetDevice where the two are the same card.
class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device_) status_ = cudaSetDevice(device_);
  }
  ~DeviceScope() {
    if (status_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  int status() const { return static_cast<int>(status_); }

 private:
  int device_, prev_ = -1;
  cudaError_t status_;
};

// Grid sizes found once are kept per card: the `MAX_DEVICES` first cards
// have a slot each; later ones are found anew on every call.
constexpr int MAX_DEVICES = 64;

// The number of blocks of `kernel` that fill the current card at `threads`
// threads and `smem` bytes of dynamic shared memory, raising the kernel's
// dynamic shared-memory limit to smem first (an attribute of each card; a
// kernel with static shared memory needs it below 48 KB too). Kept in
// cache[device] once found.
template <typename Kernel>
static cudaError_t grid_fill(Kernel kernel, int threads, size_t smem,
                             long long (&cache)[MAX_DEVICES], long long* fill) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool slot = device < MAX_DEVICES;
  if (slot && cache[device] > 0) {
    *fill = cache[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if (smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *fill = static_cast<long long>(sms) * per_sm;
  if (slot) cache[device] = *fill;
  return cudaSuccess;
}

// cp.async: asynchronous copies from device memory into shared memory, in
// 4- or 16-byte pieces, waited for by commit groups
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }
