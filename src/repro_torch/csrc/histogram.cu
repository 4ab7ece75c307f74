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

// digits (n,) int32, n >= 1 -> out (num_bins,) int32, zeroed by the caller.
extern "C" int histogram(const void* digits, long long n, int num_bins, void* out, void* stream,
                         int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* d = static_cast<const int*>(digits);
  // digits before the first 16-byte boundary are counted one by one
  const int head = static_cast<int>(
      std::min(static_cast<long long>((16 - reinterpret_cast<uintptr_t>(d) % 16) % 16 / 4), n));
  const long long n_vec = (n - head) / 4;
  const long long want = (std::max(n_vec, 4LL) + THREADS - 1) / THREADS;
  const unsigned blocks =
      static_cast<unsigned>(std::min(want, static_cast<long long>(sms) * BLOCKS_PER_SM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bins <= SMEM_BINS) {
    histogram_kernel<true><<<blocks, THREADS, num_bins * sizeof(int), st>>>(
        d, n, head, num_bins, static_cast<int*>(out));
  } else {
    histogram_kernel<false><<<blocks, THREADS, 0, st>>>(d, n, head, num_bins,
                                                        static_cast<int*>(out));
  }
  return launch_status();
}
