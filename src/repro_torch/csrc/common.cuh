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

// The card's multiprocessors and the blocks of one kernel instance that one
// of them holds; 0 until found.
struct Fill {
  int sms = 0, per_sm = 0;
};

// The blocks of `kernel` that fill the current card at `threads` threads
// and `smem` bytes of dynamic shared memory, raising the kernel's dynamic
// shared-memory limit to smem first (an attribute of each card; a kernel
// with static shared memory needs it below 48 KB too). Kept in
// cache[device] once found.
template <typename Kernel>
static cudaError_t grid_fill(Kernel kernel, int threads, size_t smem, Fill (&cache)[MAX_DEVICES],
                             Fill* fill) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool slot = device < MAX_DEVICES;
  if (slot && cache[device].per_sm > 0) {
    *fill = cache[device];
    return cudaSuccess;
  }
  Fill f;
  if (smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (f.per_sm < 1) return cudaErrorInvalidConfiguration;
  *fill = f;
  if (slot) cache[device] = f;
  return cudaSuccess;
}

// The launch one call makes: which kernel instance (its index in the
// library's INSTANCES), threads a block, bytes of dynamic shared memory and
// blocks. Each library finds it with one host helper that its launch calls,
// and hands the same helper's answer to Python through its
// `<name>_launch_config` entry, which launches nothing
// (analysis/kernel_lint.py holds it against its declaration). sms and
// per_sm are what the grid was capped by: the card's multiprocessors and
// the blocks one of them holds (per_sm a fixed count where the library does
// not ask the occupancy calculator).
struct LaunchConfig {
  int instance = 0, threads = 0;
  long long smem = 0, grid = 0;
  int sms = 0, per_sm = 0;
};

// out: (instance, threads, smem, grid, sms, per_sm)
static inline void put_config(const LaunchConfig& c, long long* out) {
  out[0] = c.instance;
  out[1] = c.threads;
  out[2] = c.smem;
  out[3] = c.grid;
  out[4] = c.sms;
  out[5] = c.per_sm;
}

// One compiled kernel instance a launch can pick.
struct KernelInstance {
  const void* fn;
  const char* name;
};

// cudaFuncGetAttributes of instance i of a library's table, into out:
// (registers a thread, local bytes a thread (spills), static shared memory,
// most threads a block, dynamic shared-memory limit, instances in the table)
static int instance_attributes(const KernelInstance* table, int count, int i, int device,
                               long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  if (i < 0 || i >= count) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, table[i].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  out[2] = static_cast<long long>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.maxDynamicSharedSizeBytes;
  out[5] = count;
  return 0;
}

// `<lib>_func_attributes(i, device, out)` and `<lib>_instance_name(i)` over
// the library's INSTANCES table
#define EXPORT_INSTANCES(lib)                                                                \
  extern "C" int lib##_func_attributes(int i, int device, long long* out) {                 \
    return instance_attributes(INSTANCES, sizeof(INSTANCES) / sizeof(INSTANCES[0]), i,      \
                               device, out);                                                 \
  }                                                                                          \
  extern "C" const char* lib##_instance_name(int i) {                                       \
    const int count = sizeof(INSTANCES) / sizeof(INSTANCES[0]);                             \
    return i >= 0 && i < count ? INSTANCES[i].name : "";                                    \
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
