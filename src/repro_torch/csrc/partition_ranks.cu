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
// written once (8 B an element), plus one row of base per tile. The rank
// walk is a few instructions a digit, if finding the lanes that hold the
// same digit (the peer mask) is.
//
// Design: the walk over a tile is sequential (32 digits a step), so a warp
// that loads as it walks keeps one 128-byte load in flight and waits on
// memory latency. Here each warp owns a double buffer in shared memory and
// walks tiles t, t + W, t + 2W, ... (W warps in a grid sized to fill the
// SMs): while it ranks tile t, cp.async copies the next tile's 4 KB of
// digits and its base row in 16-byte pieces (4-byte pieces for a ragged tail
// or an unaligned view). The base row, once landed, is the tile's running
// count per digit. One step: each lane finds its peers, its rank is the
// popcount of its lower peers, the lowest peer alone reads and advances the
// digit's count and hands the old value to its peers by a shuffle, and the
// 32 destinations go out as one coalesced 128-byte store.
// The peer mask: __match_any_sync takes longer the more distinct digits a
// step holds, and one ballot per digit bit costs 8-10 ballots a step; on the
// H100 both were slower than what follows with uniform 8-bit digits, and no
// faster at the plans' other pass widths. A step whose 32 digits are all
// equal (clustered data: the group-by's pass over the join output) takes its
// peers from one ballot. Any other step sets each lane's bit in a per-warp
// word per digit with a shared-memory atomicOr (bits commute; a step of
// equal digits would serialize them on one address) and reads its digit's
// word back. Three sets of words rotate, so a step's words are cleared one
// step later and reused two steps later with no extra barrier.
// Order comes from the walk and the lane masks, never from the order of
// atomics, so the rank is stable and the result is the same on every run.
#include "common.cuh"

constexpr int WARPS = 4;  // per block; the grid fills the SMs

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline long long min_ll(long long a, long long b) { return a < b ? a : b; }

// int32 words of shared memory per warp: two (base row, tile) buffers and
// three sets of peer words
__host__ __device__ inline int warp_words(int num_bins, int tile) {
  return 2 * (round4(num_bins) + round4(tile)) + 3 * round4(num_bins);
}

// start copying tile t's digits and base row into (sb, sd)
__device__ __forceinline__ void stage(const int* __restrict__ digits,
                                      const int* __restrict__ base, long long n, int num_bins,
                                      int tile, long long t, bool vec_digits, bool vec_base,
                                      int lane, int* sb, int* sd) {
  const long long start = t * tile;
  const int len = static_cast<int>(min_ll(tile, n - start));
  const int* src = digits + start;
  if (vec_digits && len == tile) {
    for (int i = lane * 4; i < tile; i += 128) cp_async16(sd + i, src + i);
  } else {
    for (int i = lane; i < len; i += 32) cp_async4(sd + i, src + i);
  }
  const int* brow = base + t * num_bins;
  if (vec_base) {
    for (int i = lane * 4; i < num_bins; i += 128) cp_async16(sb + i, brow + i);
  } else {
    for (int i = lane; i < num_bins; i += 32) cp_async4(sb + i, brow + i);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    partition_ranks_kernel(const int* __restrict__ digits, const int* __restrict__ base,
                           long long n, int num_bins, int tile, bool vec_digits, bool vec_base,
                           int* __restrict__ dest) {
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nbp = round4(num_bins), tp = round4(tile);
  // this warp's buffers: base rows (2, nbp), tiles (2, tp), peer words (3, nbp)
  int* sb = reinterpret_cast<int*>(smem4) + warp * warp_words(num_bins, tile);
  int* sd = sb + 2 * nbp;
  unsigned* words = reinterpret_cast<unsigned*>(sd + 2 * tp);
  for (int i = lane; i < 3 * nbp; i += 32) words[i] = 0u;
  const long long num_tiles = (n + tile - 1) / tile;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  const unsigned lower = (1u << lane) - 1u;

  long long t = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (t < num_tiles)
    stage(digits, base, n, num_bins, tile, t, vec_digits, vec_base, lane, sb, sd);
  cp_async_commit();
  int set = 0;        // the set of peer words this step uses
  int cleared = -1;   // the word this lane set as leader one step ago
  for (int buf = 0; t < num_tiles; t += stride, buf ^= 1) {
    if (t + stride < num_tiles)
      stage(digits, base, n, num_bins, tile, t + stride, vec_digits, vec_base, lane,
            sb + (buf ^ 1) * nbp, sd + (buf ^ 1) * tp);
    cp_async_commit();
    cp_async_wait_one();
    __syncwarp();  // every lane's copies of tile t have landed
    int* run = sb + buf * nbp;
    const int* dig = sd + buf * tp;
    const long long start = t * tile;
    const int len = static_cast<int>(min_ll(tile, n - start));
    for (int i0 = 0; i0 < len; i0 += 32) {
      const int i = i0 + lane;
      const int d = i < len ? dig[i] : -1;
      const bool ok = d >= 0 && d < num_bins;
      if (cleared >= 0) words[cleared] = 0u;  // the last step's word: all lanes read it
      cleared = -1;
      unsigned peers;
      const int first = __shfl_sync(0xffffffffu, d, 0);
      if (__all_sync(0xffffffffu, d == first)) {
        peers = __ballot_sync(0xffffffffu, ok);
      } else {
        unsigned* w = words + set * nbp;
        if (ok) atomicOr(w + d, 1u << lane);
        __syncwarp();
        peers = ok ? w[d] : 0u;
        if (ok && __popc(peers & lower) == 0) cleared = set * nbp + d;
      }
      set = set == 2 ? 0 : set + 1;
      const int rank = __popc(peers & lower);
      const bool leader = ok && rank == 0;
      const int cur = __shfl_sync(0xffffffffu, leader ? run[d] : 0,
                                  ok ? __ffs(peers) - 1 : lane);
      if (leader) run[d] = cur + __popc(peers);
      __syncwarp();  // the next step's leaders read these counts
      if (i < len) dest[start + i] = ok ? cur + rank : -1;
    }
  }
}

static const KernelInstance INSTANCES[] = {
    {(const void*)partition_ranks_kernel, "partition_ranks"}};
EXPORT_INSTANCES(partition_ranks)

// The launch of one call: WARPS warps a block, each with its buffers and
// peer words in dynamic shared memory (the limit raised past 48 KB when
// they need more); as many blocks as fill the card, and no more than one
// per WARPS tiles.
static cudaError_t config(long long n, int num_bins, int tile, int device, LaunchConfig* c) {
  if (n < 1 || num_bins < 1 || tile < 1) return cudaErrorInvalidValue;
  c->threads = WARPS * 32;
  c->smem = static_cast<long long>(WARPS) * warp_words(num_bins, tile) * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (c->smem > 48 * 1024)
    err = cudaFuncSetAttribute(partition_ranks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(c->smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->per_sm, partition_ranks_kernel,
                                                        c->threads, c->smem);
  if (err != cudaSuccess) return err;
  if (c->per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long num_tiles = (n + tile - 1) / tile;
  c->grid = min_ll(static_cast<long long>(c->sms) * c->per_sm, (num_tiles + WARPS - 1) / WARPS);
  return cudaSuccess;
}

extern "C" int partition_ranks_launch_config(long long n, int num_bins, int tile, int device,
                                             long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(n, num_bins, tile, device, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

// base: (ceil(n / tile), num_bins) int32; dest: (n,) int32.
extern "C" int partition_ranks(const void* digits, const void* base, long long n,
                               int num_bins, int tile, void* dest, void* stream,
                               int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(n, num_bins, tile, device, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* d = static_cast<const int*>(digits);
  const int* b = static_cast<const int*>(base);
  const bool vec_digits = tile % 4 == 0 && reinterpret_cast<size_t>(d) % 16 == 0;
  const bool vec_base = num_bins % 4 == 0 && reinterpret_cast<size_t>(b) % 16 == 0;
  partition_ranks_kernel<<<static_cast<unsigned>(c.grid), c.threads, c.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      d, b, n, num_bins, tile, vec_digits, vec_base, static_cast<int*>(dest));
  return launch_status();
}
