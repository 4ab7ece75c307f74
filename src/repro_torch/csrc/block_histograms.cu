// Per-tile digit histograms: the first half of every radix-partition pass.
//
// Replaces: src/repro/kernels/radix_partition.py, block_histograms_pallas
// (_block_hist_kernel), which sums a one-hot expansion of each 1024-digit
// block on the TPU's vector unit.
//
// What bounds it: bytes. Every digit is read once (4 B) and each tile writes
// one row of num_bins counts; there is one add per digit.
//
// Design: one thread block per tile. The tile's counts live in shared memory
// and are incremented with shared-memory atomics: counts commute, so the
// result does not depend on the order of the atomics. Negative digits (pad
// slots) and digits >= num_bins are not counted. The row is then written
// with coalesced stores.
#include "common.cuh"

__global__ void block_histograms_kernel(const int* __restrict__ digits, long long n,
                                        int num_bins, int tile, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long end = min(start + tile, n);
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int d = digits[i];
    if (d >= 0 && d < num_bins) atomicAdd(&hist[d], 1);
  }
  __syncthreads();
  int* row = out + static_cast<long long>(blockIdx.x) * num_bins;
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) row[b] = hist[b];
}

// out: (ceil(n / tile), num_bins) int32.
extern "C" int block_histograms(const void* digits, long long n, int num_bins, int tile,
                                void* out, void* stream) {
  const long long num_tiles = (n + tile - 1) / tile;
  const int threads = 256;
  block_histograms_kernel<<<static_cast<unsigned>(num_tiles), threads,
                            num_bins * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(digits), n, num_bins, tile, static_cast<int*>(out));
  return launch_status();
}
