// Global digit histogram: out[b] = #{i : digits[i] == b} for b in
// [0, num_bins). Digits < 0 (PAD_DIGIT) and >= num_bins count nowhere.
//
// Replaces: src/repro/kernels/histogram.py, histogram_pallas
// (_hist_kernel), which sums a one-hot expansion of each (8, 128) block of
// digits on the TPU's vector unit into one output block carried across a
// sequential grid.
//
// What bounds it: bytes. Each digit is read once (4 B) and the counts are
// written once; one add per digit.
//
// Design: a grid-stride loop over the digits with 16-byte vector loads (a
// scalar head up to the first aligned digit and a scalar tail). When the
// counts fit shared memory (SMEM_BINS), each block counts into its own
// shared histogram with shared-memory atomics and then adds its nonzero
// bins into the output with global atomics; otherwise every digit adds
// straight into the output in global memory. Integer counts commute, so the
// result does not depend on the order of the atomics. The output is zeroed
// by the caller.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int SMEM_BINS = 12288;  // 48 KB of int32 counts
constexpr int BLOCKS_PER_SM = 8;

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int* __restrict__ digits, long long n, int head, int num_bins,
                 int* __restrict__ out) {
  extern __shared__ int smem_hist[];
  int* hist = SHARED ? smem_hist : out;
  if (SHARED) {
    for (int b = threadIdx.x; b < num_bins; b += THREADS) smem_hist[b] = 0;
    __syncthreads();
  }
  auto count = [&](int d) {
    if (d >= 0 && d < num_bins) atomicAdd(&hist[d], 1);
  };
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (tid < head) count(digits[tid]);
  const long long n_vec = (n - head) / 4;
  const int4* vec = reinterpret_cast<const int4*>(digits + head);
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 v = vec[i];
    count(v.x);
    count(v.y);
    count(v.z);
    count(v.w);
  }
  const long long tail = head + n_vec * 4 + tid;
  if (tail < n) count(digits[tail]);
  if (SHARED) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_bins; b += THREADS) {
      const int c = smem_hist[b];
      if (c) atomicAdd(&out[b], c);
    }
  }
}

static const KernelInstance INSTANCES[] = {
    {(const void*)histogram_kernel<false>, "histogram<false>"},
    {(const void*)histogram_kernel<true>, "histogram<true>"}};
EXPORT_INSTANCES(histogram)

// digits before the first 16-byte boundary, counted one by one
static int head_of(const int* digits, long long n) {
  return static_cast<int>(std::min(
      static_cast<long long>((16 - reinterpret_cast<uintptr_t>(digits) % 16) % 16 / 4), n));
}

// The launch of one call: the shared-memory instance when the counts fit
// SMEM_BINS, else the device-memory one; THREADS threads a block, one
// 16-byte vector a thread, at most BLOCKS_PER_SM blocks an SM.
static cudaError_t config(const int* digits, long long n, int num_bins, int device,
                          LaunchConfig* c) {
  if (n < 1 || num_bins < 1) return cudaErrorInvalidValue;
  const cudaError_t err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  c->instance = num_bins <= SMEM_BINS;
  c->threads = THREADS;
  c->smem = c->instance ? static_cast<long long>(num_bins) * sizeof(int) : 0;
  c->per_sm = BLOCKS_PER_SM;
  const long long n_vec = (n - head_of(digits, n)) / 4;
  const long long want = (std::max(n_vec, 4LL) + THREADS - 1) / THREADS;
  c->grid = std::min(want, static_cast<long long>(c->sms) * BLOCKS_PER_SM);
  return cudaSuccess;
}

extern "C" int histogram_launch_config(const void* digits, long long n, int num_bins, int device,
                                       long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(static_cast<const int*>(digits), n, num_bins, device, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

// digits (n,) int32, n >= 1 -> out (num_bins,) int32, zeroed by the caller.
extern "C" int histogram(const void* digits, long long n, int num_bins, void* out, void* stream,
                         int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const int* d = static_cast<const int*>(digits);
  LaunchConfig c;
  const cudaError_t err = config(d, n, num_bins, device, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = c.instance ? histogram_kernel<true> : histogram_kernel<false>;
  kernel<<<static_cast<unsigned>(c.grid), c.threads, c.smem, static_cast<cudaStream_t>(stream)>>>(
      d, n, head_of(d, n), num_bins, static_cast<int*>(out));
  return launch_status();
}
