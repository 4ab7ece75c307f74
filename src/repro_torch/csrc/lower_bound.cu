// Lower bound of each probe key in a sorted build column (SMJ match finding):
//   out[j] = #{i : build[i] < probe[j]}, an int32 in [0, n_build].
// The probe column is sorted too (the join sorts both sides), which keeps
// each tile's bounds in a narrow range of the build column; the result is
// right for probe keys in any order and for any span.
//
// Replaces: src/repro/kernels/merge_join.py, lower_bound_windowed_pallas
// (_lb_kernel), which counts, for each tile of 1024 probe keys, the keys of
// a 2W window of the build column that are smaller, with the window chosen
// ahead by a scalar-prefetched index, INT_MAX padding, and a host-side check
// that sends tiles wider than the window to searchsorted.
//
// What bounds it: bytes. Each probe key is read once and one int32 written;
// the build keys inside a tile's range are read about once over all tiles.
// A binary search costs log2(window) compares per key, far below the
// card's integer rate.
//
// Design: one thread block per tile of TILE probe keys, PER_THREAD keys per
// thread held in registers. The block reduces its keys to their minimum
// and maximum; warp 0 finds lo = lower_bound(min) and warp 1 hi =
// lower_bound(max) in the whole build column, each by a 32-way search (one
// load per lane and a ballot per step: five steps for 15M keys). Every
// lower bound in the tile lies in [lo, hi]. When hi - lo fits the shared
// window, build[lo, hi) is staged there with coalesced loads and each thread
// binary-searches its keys in shared memory; otherwise each thread
// binary-searches global memory within [lo, hi). Sentinel keys (-1) sort
// first and need no special case.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;
constexpr int WINDOW = 4096;

// first index in [lo, hi) whose key is >= key, else hi
template <typename K>
__device__ __forceinline__ int lower_bound_in(const K* a, int lo, int hi, K key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the same, by one whole warp: each step splits [lo, hi) into 32 chunks,
// lane c loads the last key of chunk c, and the ballot of keys < key counts
// the chunks wholly below key. The result is the same in every lane.
template <typename K>
__device__ int warp_lower_bound(const K* __restrict__ a, int lo, int hi, K key, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int last = lo + static_cast<int>(min(static_cast<long long>(lane + 1) * step,
                                               static_cast<long long>(hi - lo))) - 1;
    const unsigned below = __ballot_sync(0xffffffffu, a[last] < key);
    const int c = __popc(below);
    if (c == 32) return hi;
    // chunk c ends with a key >= key: the bound lies in it
    hi = lo + static_cast<int>(min(static_cast<long long>(c + 1) * step,
                                   static_cast<long long>(hi - lo)));
    lo = lo + c * step;
  }
  const bool lt = lo + lane < hi && a[lo + lane] < key;
  return lo + __popc(__ballot_sync(0xffffffffu, lt));
}

template <typename K>
__global__ void __launch_bounds__(THREADS)
lower_bound_kernel(const K* __restrict__ build, int n_build, const K* __restrict__ probe,
                   long long n_probe, int* __restrict__ out) {
  __shared__ K window[WINDOW];
  __shared__ K warp_min[THREADS / 32], warp_max[THREADS / 32];
  __shared__ int bounds[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * TILE;

  K keys[PER_THREAD];
  K kmin = probe[base], kmax = probe[base];  // the tile's first key is in range
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long r = base + j * THREADS + tid;
    keys[j] = r < n_probe ? probe[r] : probe[base];
    kmin = min(kmin, keys[j]);
    kmax = max(kmax, keys[j]);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, s));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, s));
  }
  if (lane == 0) {
    warp_min[warp] = kmin;
    warp_max[warp] = kmax;
  }
  __syncthreads();
  if (warp < 2) {
    K key = warp == 0 ? warp_min[0] : warp_max[0];
    for (int w = 1; w < THREADS / 32; ++w)
      key = warp == 0 ? min(key, warp_min[w]) : max(key, warp_max[w]);
    const int b = warp_lower_bound(build, 0, n_build, key, lane);
    if (lane == 0) bounds[warp] = b;
  }
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1], span = hi - lo;

  int res[PER_THREAD];
  if (span <= WINDOW) {  // the same branch for the whole block
    for (int i = tid; i < span; i += THREADS) window[i] = build[lo + i];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) res[j] = lo + lower_bound_in(window, 0, span, keys[j]);
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) res[j] = lower_bound_in(build, lo, hi, keys[j]);
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long r = base + j * THREADS + tid;
    if (r < n_probe) out[r] = res[j];
  }
}

template <typename K>
static int launch(const void* build, int n_build, const void* probe, long long n_probe, void* out,
                  cudaStream_t stream) {
  const long long tiles = (n_probe + TILE - 1) / TILE;
  lower_bound_kernel<K><<<static_cast<unsigned>(tiles), THREADS, 0, stream>>>(
      static_cast<const K*>(build), n_build, static_cast<const K*>(probe), n_probe,
      static_cast<int*>(out));
  return launch_status();
}

// build (n_build,) and probe (n_probe,) of one key type, int32 or int64
// (key_bytes 4 or 8), build sorted ascending; n_build < 2^31, n_probe >= 1
// -> out (n_probe,) int32.
extern "C" int lower_bound(const void* build, int n_build, const void* probe, long long n_probe,
                           int key_bytes, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8) return launch<long long>(build, n_build, probe, n_probe, out, st);
  return launch<int>(build, n_build, probe, n_probe, out, st);
}
