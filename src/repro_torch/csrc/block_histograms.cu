// Per-tile digit histograms: the first half of every radix-partition pass.
// Row t of the output counts the digits d in [0, num_bins) of tile t (digits
// [t * tile, (t + 1) * tile)); pad digits (< 0) and digits >= num_bins count
// nowhere.
//
// Replaces: src/repro/kernels/radix_partition.py, block_histograms_pallas
// (_block_hist_kernel), which sums a one-hot expansion of each 1024-digit
// block on the TPU's vector unit.
//
// What bounds it: bytes. Every digit is read once (4 B) and each tile writes
// one row of num_bins counts; there is one add per digit.
//
// Design: persistent blocks of WARPS warps; each warp owns one tile at a time
// and walks the tiles with a stride of all warps. It counts into its own
// sub-histogram in shared memory with shared-memory atomics (counts commute,
// so the result does not depend on their order), writes the row with
// coalesced (16-byte where the row allows) stores, and clears each bin as it
// reads it. Only __syncwarp orders the warp's counting, reading and
// clearing: no block-wide barrier per tile. On the path's 1024-digit tiles a
// lane loads its eight 16-byte vectors of the tile at once; other tile
// widths, unaligned digits and a ragged last tile are counted digit by
// digit. Keeping the warp's next tile in flight as well, in registers, was
// no faster (scripts/kernel_variants.py), so the warps the SM holds are what
// keep its loads in flight.
#include <algorithm>

#include "common.cuh"

constexpr int WARPS = 8;
// the tile the vector path takes: 8 int4 vectors a lane
constexpr int VEC_TILE = 1024;
constexpr int VECS = VEC_TILE / 4 / 32;

__device__ __forceinline__ void count_digit(int* hist, int d, int num_bins) {
  if (static_cast<unsigned>(d) < static_cast<unsigned>(num_bins)) atomicAdd(&hist[d], 1);
}

__device__ __forceinline__ void load_tile(int4 (&v)[VECS], const int4* __restrict__ d4,
                                          long long t, int lane) {
  const int4* src = d4 + t * (VEC_TILE / 4) + lane;
#pragma unroll
  for (int i = 0; i < VECS; ++i) v[i] = src[i * 32];
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32) block_histograms_kernel(
    const int* __restrict__ digits, long long n, int num_bins, int tile, long long num_tiles,
    int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* hist = smem + w * num_bins;
  for (int b = lane; b < num_bins; b += 32) hist[b] = 0;
  __syncwarp();
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  // tiles the vector path reads whole
  const long long full = VEC ? n / VEC_TILE : 0;
  const int4* d4 = reinterpret_cast<const int4*>(digits);
  const bool vec_row = num_bins % 4 == 0;
  long long t = static_cast<long long>(blockIdx.x) * WARPS + w;
  for (; t < num_tiles; t += stride) {
    if (VEC && t < full) {
      int4 cur[VECS];
      load_tile(cur, d4, t, lane);
#pragma unroll
      for (int i = 0; i < VECS; ++i) {
        count_digit(hist, cur[i].x, num_bins);
        count_digit(hist, cur[i].y, num_bins);
        count_digit(hist, cur[i].z, num_bins);
        count_digit(hist, cur[i].w, num_bins);
      }
    } else {
      const long long start = t * tile;
      const long long end = min(start + tile, n);
      for (long long i = start + lane; i < end; i += 32) count_digit(hist, digits[i], num_bins);
    }
    __syncwarp();
    int* row = out + t * num_bins;
    if (vec_row) {
      int4* row4 = reinterpret_cast<int4*>(row);
      int4* hist4 = reinterpret_cast<int4*>(hist);
      for (int b = lane; b < num_bins / 4; b += 32) {
        row4[b] = hist4[b];
        hist4[b] = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int b = lane; b < num_bins; b += 32) {
        row[b] = hist[b];
        hist[b] = 0;
      }
    }
    __syncwarp();
  }
}

static const KernelInstance INSTANCES[] = {
    {(const void*)block_histograms_kernel<false>, "block_histograms<false>"},
    {(const void*)block_histograms_kernel<true>, "block_histograms<true>"}};
EXPORT_INSTANCES(block_histograms)

// The launch of one call: the vector instance for 1024-digit tiles of
// 16-byte aligned digits, else the digit-by-digit one; WARPS warps a block,
// each with a sub-histogram in shared memory; as many blocks as fill the
// card, and no more than one per WARPS tiles.
static cudaError_t config(const int* digits, long long n, int num_bins, int tile,
                          LaunchConfig* c) {
  if (n < 1 || num_bins < 1 || num_bins > 1024 || tile < 1) return cudaErrorInvalidValue;
  c->instance = tile == VEC_TILE && reinterpret_cast<size_t>(digits) % 16 == 0;
  c->threads = WARPS * 32;
  c->smem = static_cast<long long>(WARPS) * num_bins * sizeof(int);
  // at most 1024 bins: 32 KB, under the 48 KB every kernel may take, so the
  // blocks an SM holds do not depend on num_bins past the registers
  static Fill cache[2][MAX_DEVICES] = {};
  Fill fill;
  auto kernel = c->instance ? block_histograms_kernel<true> : block_histograms_kernel<false>;
  const cudaError_t err = grid_fill(kernel, c->threads, 32 * 1024, cache[c->instance], &fill);
  if (err != cudaSuccess) return err;
  c->sms = fill.sms;
  c->per_sm = fill.per_sm;
  const long long want = ((n + tile - 1) / tile + WARPS - 1) / WARPS;
  c->grid = std::min(want, static_cast<long long>(fill.sms) * fill.per_sm);
  return cudaSuccess;
}

extern "C" int block_histograms_launch_config(const void* digits, long long n, int num_bins,
                                              int tile, int device, long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(static_cast<const int*>(digits), n, num_bins, tile, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

// digits (n,) int32, n >= 1, 1 <= num_bins <= 1024 -> out
// (ceil(n / tile), num_bins) int32, 16-byte aligned.
extern "C" int block_histograms(const void* digits, long long n, int num_bins, int tile,
                                void* out, void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  auto d = static_cast<const int*>(digits);
  LaunchConfig c;
  const cudaError_t err = config(d, n, num_bins, tile, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = c.instance ? block_histograms_kernel<true> : block_histograms_kernel<false>;
  kernel<<<static_cast<unsigned>(c.grid), c.threads, c.smem, static_cast<cudaStream_t>(stream)>>>(
      d, n, num_bins, tile, (n + tile - 1) / tile, static_cast<int*>(out));
  return launch_status();
}
