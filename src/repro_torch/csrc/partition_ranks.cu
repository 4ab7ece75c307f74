// Stable destination of every element in one radix-partition pass:
//   dest[i] = base[tile(i)][d] + |{j < i in the same tile : digit[j] == d}|,
// or -1 for a pad slot (negative digit, or a digit >= num_bins).
// base is the exclusive prefix of the tile histograms over (digit, tile),
// computed outside the kernel.
//
// Replaces: src/repro/kernels/radix_partition.py, partition_ranks_pallas
// (_rank_kernel), which ranks a 1024-digit block by a cumulative sum over its
// (1024, num_bins) one-hot expansion on the TPU's vector unit.
//
// What bounds it: bytes. Each digit is read once and each destination
// written once (8 B an element), plus one row of base per tile.
//
// Design: one warp per tile, so no block-wide barrier is needed and each
// warp keeps its own running count per digit in shared memory, seeded with
// the tile's base row. The warp walks its tile 32 elements at a time, in
// order: __match_any_sync gives each lane the lanes holding the same digit,
// and the lane's rank among them is the popcount of the lower peers. The
// lowest peer then advances the digit's running count by the group's size.
// Order comes from the walk and the lane masks, never from atomics, so the
// rank is stable and the result is the same on every run.
#include "common.cuh"

__global__ void partition_ranks_kernel(const int* __restrict__ digits,
                                       const int* __restrict__ base, long long n,
                                       int num_bins, int tile, int* __restrict__ dest) {
  extern __shared__ int running[];  // (warps per block, num_bins)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long num_tiles = (n + tile - 1) / tile;
  const long long t = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;  // the whole warp leaves together
  int* run = running + warp * num_bins;
  const int* brow = base + t * num_bins;
  for (int b = lane; b < num_bins; b += 32) run[b] = brow[b];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const long long start = t * tile;
  const long long end = min(start + tile, n);
  for (long long i0 = start; i0 < end; i0 += 32) {
    const long long i = i0 + lane;
    const int d = i < end ? digits[i] : -1;
    const bool ok = d >= 0 && d < num_bins;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? d : -1);
    const int rank = __popc(peers & lower);
    const int cur = ok ? run[d] : 0;
    __syncwarp();
    if (ok && rank == 0) run[d] = cur + __popc(peers);
    __syncwarp();
    if (i < end) dest[i] = ok ? cur + rank : -1;
  }
}

// base: (ceil(n / tile), num_bins) int32; dest: (n,) int32.
extern "C" int partition_ranks(const void* digits, const void* base, long long n,
                               int num_bins, int tile, void* dest, void* stream) {
  const long long num_tiles = (n + tile - 1) / tile;
  const int warps = 8;
  const long long blocks = (num_tiles + warps - 1) / warps;
  partition_ranks_kernel<<<static_cast<unsigned>(blocks), warps * 32,
                           warps * num_bins * sizeof(int),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(digits), static_cast<const int*>(base), n, num_bins, tile,
      static_cast<int*>(dest));
  return launch_status();
}
