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
// What bounds it: bytes, once each key costs a few instructions (each probe
// key read once and one int32 written; the build keys inside the tiles'
// ranges read about once over all tiles); on a short probe column spread over
// a long build column, the latency of the loads each key depends on.
//
// Design: persistent blocks of 256 threads, each walking a contiguous run of
// tiles of 256 x PER probe keys; thread t holds keys [t PER, (t + 1) PER) of
// a tile, a run of consecutive keys. Per tile:
//   - its keys were copied into shared memory by cp.async (16-byte pieces
//     where aligned) while the tile before was worked on (a double buffer);
//   - a ring in shared memory holds the build column from the last tile's hi
//     on: after each tile the block copies (cp.async) the keys after the ones
//     it holds, up to RING past the tile's lo, and a tile reads only the
//     copies issued two tiles before, so their loads are long in flight;
//   - a sorted tile that starts at or above the last tile's maximum (every
//     tile of a sorted column after a block's first two) has its bounds
//     lo = lower_bound(first key) and hi = lower_bound(last key) found by
//     warp 0 in the ring, by a 32-way search with one ballot a step, while the
//     other warps check that the tile is sorted;
//   - any other tile (a range past the ring, a block's first tile, unsorted
//     keys): the block reduces its keys to a minimum and a maximum. When the
//     tile is at or above the last tile's maximum, warps 0 and 1 search device
//     memory for lo and hi from the last tile's hi (a first step of 32 chunks
//     two spans wide, then 32-way searches); otherwise a coarse index of the
//     column, every ceil(n / COARSE)-th key (the same lines for every block,
//     which L2 keeps), brackets them, and the tile's exact hi comes out of its
//     merge as its largest bound. The bracket is staged into the ring (all
//     loads issued before any store); a bracket wider than the ring stages a
//     sampled index of it instead, every s-th key with s = ceil(span / SAMPLE);
//   - each thread merges its run against the bracket: a branch-free binary
//     search for its first key, then for each next key a walk of up to WALK
//     steps from the last bound and a binary search past it (a key smaller
//     than the one before it is searched from the start). With a sampled
//     index, a key searches the sample, then the keys between two samples in
//     device memory, all of a thread's keys in lockstep so that their loads
//     are in flight together;
//   - the bounds of a run are written by 16-byte stores where whole.
// The tile shrinks from 2048 keys to 256 when the probe column is short, so
// that the grid keeps at least two blocks per SM. Sentinel keys (-1) sort
// first and need no special case.
//
// What holds it back: at J2's shape 96% of the tiles find their bounds in the
// ring, yet with the merge cut out the kernel still takes about 0.26 ms,
// against 0.19 for a plain copy of its probe keys into an int32 output; the
// merge adds about a fifth. On a short probe column the device time is level
// with torch.searchsorted's, and the launch's host path is longer.
//
// Tried and dropped (times in PERF.md): a window fetched one tile ahead that
// each thread searched for the tile's bounds, and the same bounds searched by
// every warp in the ring (both bound by those searches' instructions);
// 1024-key tiles at 6 or 8 blocks an SM, and 5 or 6 blocks of 2048-key tiles
// under a register cap (all slower); a 16 KB ring, the keys copied two tiles
// ahead, 16-byte loads of each run and stores made contiguous by shuffles (all
// level); for wide ranges, a sampled index of 4096 keys (it reads about every
// line of the range) and a 32-way warp search per key (32 keys a warp, one
// after another).
#include <climits>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RING_BYTES = 32 * 1024;  // build keys held per block (a power of two)
constexpr int SAMPLE = 512;            // most entries of a wide tile's sampled index
constexpr int COARSE = 1024;           // most entries of the column's coarse index
constexpr int WALK = 4;                // linear steps of the merge before it searches
constexpr unsigned FULL = 0xffffffffu;

template <typename K>
__device__ __forceinline__ K highest();
template <>
__device__ __forceinline__ int highest<int>() { return INT_MAX; }
template <>
__device__ __forceinline__ long long highest<long long>() { return LLONG_MAX; }
template <typename K>
__device__ __forceinline__ K lowest();
template <>
__device__ __forceinline__ int lowest<int>() { return INT_MIN; }
template <>
__device__ __forceinline__ long long lowest<long long>() { return LLONG_MIN; }

// #{i in [0, n) : at(i) < key} for ascending at(i), by halving steps that
// depend on n alone (no early exit)
template <typename K, typename At>
__device__ __forceinline__ int count_below(At at, int n, K key) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = at(base + half - 1) < key ? base + half : base;
    n -= half;
  }
  return base + (n == 1 && at(base) < key);
}

// the same by one whole warp: each step splits [lo, hi) into 32 chunks, lane
// c reads the last key of chunk c, and the ballot of keys < key counts the
// chunks wholly below key. The result is the same in every lane.
template <typename K, typename At>
__device__ __forceinline__ int warp_count_below(At at, int n, K key, int lane) {
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int last = lo + static_cast<int>(min(static_cast<long long>(lane + 1) * step,
                                               static_cast<long long>(hi - lo))) - 1;
    const int c = __popc(__ballot_sync(FULL, at(last) < key));
    if (c == 32) return hi;
    // chunk c ends with a key >= key: the bound lies in it
    hi = lo + static_cast<int>(min(static_cast<long long>(c + 1) * step,
                                   static_cast<long long>(hi - lo)));
    lo = lo + c * step;
  }
  const bool lt = lo + lane < hi && at(lo + lane) < key;
  return lo + __popc(__ballot_sync(FULL, lt));
}

// lower bound of key in a[from, n), where a[from - 1] < key, by one warp: a
// first step of 32 chunks of `chunk` keys from `from`, then a 32-way search
// in the first chunk that ends at or above key (or in all past the chunks)
template <typename K>
__device__ int warp_search_from(const K* __restrict__ a, int from, int n, K key, int chunk,
                                int lane) {
  const long long end = from + static_cast<long long>(lane + 1) * chunk - 1;
  const int c = __popc(__ballot_sync(FULL, end < n && a[end] < key));
  const int lo = static_cast<int>(from + static_cast<long long>(c) * chunk);
  const int hi = c < 32 ? static_cast<int>(min(static_cast<long long>(lo) + chunk,
                                               static_cast<long long>(n)))
                        : n;
  return lo + warp_count_below([&](int i) { return a[lo + i]; }, hi - lo, key, lane);
}

// wait until at most two groups of this thread's copies are in flight
__device__ __forceinline__ void cp_async_wait_two() {
  asm volatile("cp.async.wait_group 2;\n" ::);
}

template <typename K>
__device__ __forceinline__ void cp_async_key(K* dst, const K* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(K)));
}

// copy the keys of the tile at `first` into buf: 16-byte pieces when the tile
// is whole and aligned, else key by key
template <typename K, int TILE>
__device__ __forceinline__ void copy_tile(K* buf, const K* __restrict__ probe, long long n,
                                          long long first, bool aligned) {
  if (aligned && first + TILE <= n) {
    constexpr int PIECES = TILE * static_cast<int>(sizeof(K)) / 16;
    for (int q = threadIdx.x; q < PIECES; q += THREADS)
      cp_async16(reinterpret_cast<int4*>(buf) + q,
                 reinterpret_cast<const int4*>(probe + first) + q);
  } else {
    const int len = static_cast<int>(min(static_cast<long long>(TILE), n - first));
    for (int i = threadIdx.x; i < len; i += THREADS) cp_async_key(buf + i, probe + first + i);
  }
}

// stage cnt keys, build[lo + i * stride] for i < cnt, into window[(at + i) &
// mask]: each thread issues all of its loads before its first store
template <typename K>
__device__ __forceinline__ void stage(K* window, int at, int mask, const K* __restrict__ build,
                                      int lo, int stride, int cnt) {
  constexpr int U = 4;
  for (int i0 = 0; i0 < cnt; i0 += U * THREADS) {
    K v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < cnt) v[u] = build[lo + static_cast<long long>(i) * stride];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < cnt) window[(at + i) & mask] = v[u];
    }
  }
}

// The blocks of an instance that one H100 SM's shared memory holds (228 KB,
// 1 KB of it reserved a block), at most 4: the register cap of its
// __launch_bounds__. A cap the shared memory cannot fill only makes the
// compiler spill: int64 keys in tiles of 2048 hold 3 blocks an SM.
template <typename K, int PER>
constexpr int min_blocks() {
  constexpr int smem = RING_BYTES + 2 * THREADS * PER * static_cast<int>(sizeof(K));
  constexpr int fit = 233472 / (smem + 1024);
  return fit < 4 ? fit : 4;
}

template <typename K, int PER>
__global__ void __launch_bounds__(THREADS, min_blocks<K, PER>())
lower_bound_kernel(const K* __restrict__ build, int n_build, const K* __restrict__ probe,
                   long long n_probe, long long num_tiles, bool aligned, int* __restrict__ out) {
  constexpr int TILE = THREADS * PER;
  constexpr int RING = RING_BYTES / static_cast<int>(sizeof(K));
  constexpr int MASK = RING - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  K* ring = reinterpret_cast<K*>(smem);  // build[g] in slot g & MASK
  K* keybuf = ring + RING;               // two tiles
  __shared__ K red_min[WARPS], red_max[WARPS];
  __shared__ int bounds[3];  // lo, hi, and whether warp 0 found them in the ring
  __shared__ int tile_hi;    // the largest bound of a tile bracketed by the coarse index
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = num_tiles * blockIdx.x / gridDim.x;
  const long long t1 = num_tiles * (blockIdx.x + 1) / gridDim.x;
  const auto in_ring = [&](int start) { return [=](int i) { return ring[(start + i) & MASK]; }; };
  // warp 0: the bounds of [tmin, tmax] among the ring's keys of
  // build[last_hi, ready), found when build[ready - 1] >= tmax
  const auto ring_bounds = [&](K tmin, K tmax, int last_hi, int ready) {
    const int n = ready - last_hi;
    const int c = warp_count_below<K>(in_ring(last_hi), n, tmax, lane);
    const bool hit = c < n || ready == n_build;
    const int a = hit ? warp_count_below<K>(in_ring(last_hi), c, tmin, lane) : 0;
    if (lane == 0) {
      bounds[0] = last_hi + a;
      bounds[1] = last_hi + c;
      bounds[2] = hit;
    }
  };

  copy_tile<K, TILE>(keybuf, probe, n_probe, t0 * TILE, aligned);
  cp_async_commit();
  cp_async_commit();  // no build keys ahead yet
  // the last tile's maximum, hi and span; the ring's copies issued up to
  // build index `issued`, and as far as they had been issued at the end of
  // the last tile and of the one before it (those are in once the top of
  // the loop waits)
  K last_max = highest<K>();
  int last_hi = 0, last_span = n_build, issued = 0, issued1 = 0, issued2 = 0;
  bool coarse = false;  // the last tile was bracketed by the coarse index
  for (long long t = t0; t < t1; ++t) {
    const int b = static_cast<int>((t - t0) & 1);
    const K* tile = keybuf + b * TILE;
    if (t + 1 < t1)
      copy_tile<K, TILE>(keybuf + (b ^ 1) * TILE, probe, n_probe, (t + 1) * TILE, aligned);
    cp_async_commit();
    // all but the two newest groups (the next tile's keys, the ring's copies
    // issued by the last tile): this tile's keys, and the ring's copies
    // issued two tiles ago
    cp_async_wait_two();
    __syncthreads();  // for every thread; the last tile is done with
    if (coarse) {  // the last tile's hi is known now, and the ring holds nothing ahead
      last_hi = issued = issued1 = issued2 = tile_hi;
      coarse = false;
    }
    const long long first = t * TILE + static_cast<long long>(tid) * PER;
    const int valid = static_cast<int>(max(0LL, min(static_cast<long long>(PER), n_probe - first)));
    const int n_tile = static_cast<int>(min(static_cast<long long>(TILE), n_probe - t * TILE));
    // every read of the tile's buffer comes before the barrier below: the
    // next copy into it starts at the top of the next iteration
    K tmin = tile[0], tmax = tile[n_tile - 1];
    K keys[PER];
    bool ok = valid == 0 || tid == 0 || tile[tid * PER - 1] <= tile[tid * PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      keys[j] = tile[tid * PER + j];
      if (j > 0 && j < valid) ok = ok && keys[j - 1] <= keys[j];
    }
    // if the tile is sorted, its first and last keys bound it; if it also
    // starts at or above the last tile's maximum, its bounds lie at or past
    // last_hi, and the ring may hold them
    const bool fwd = tmin >= last_max;
    if (warp == 0 && fwd) ring_bounds(tmin, tmax, last_hi, issued2);
    const bool sorted = __syncthreads_and(ok);
    bool found = sorted && fwd && bounds[2];
    if (sorted && fwd && !found && issued > issued2) {
      // past the keys surely in: wait for the newer copies, and look again
      cp_async_wait_all();
      __syncthreads();
      if (warp == 0) ring_bounds(tmin, tmax, last_hi, issued);
      __syncthreads();
      found = bounds[2];
    }
    int lo = bounds[0], hi = bounds[1], stride = 1, cnt = 0;
    if (!found) {  // the same branch for the whole block
      cp_async_wait_all();  // no copy may land in the ring after the stage below
      K kmin = highest<K>(), kmax = lowest<K>();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (j < valid) {
          kmin = min(kmin, keys[j]);
          kmax = max(kmax, keys[j]);
        }
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(FULL, kmin, s));
        kmax = max(kmax, __shfl_xor_sync(FULL, kmax, s));
      }
      if (lane == 0) {
        red_min[warp] = kmin;
        red_max[warp] = kmax;
      }
      __syncthreads();  // also: every thread has read bounds
      tmin = red_min[0];
      tmax = red_max[0];
      for (int w = 1; w < WARPS; ++w) {
        tmin = min(tmin, red_min[w]);
        tmax = max(tmax, red_max[w]);
      }
      // at or above the last tile's maximum: every bound is >= last_hi, and
      // near it, so warps 0 and 1 search two spans ahead of it first. Else
      // (a block's first tile, unsorted keys) a coarse index of the column,
      // every gs-th key (the same lines for every block, which L2 keeps),
      // brackets the bounds to within gs keys; the tile's last bound is then
      // known after its merge, as the largest of its bounds.
      coarse = tmin < last_max;
      if (!coarse) {
        if (warp < 2) {
          const int bound = warp_search_from(build, last_hi, n_build, warp == 0 ? tmin : tmax,
                                             max(2, (last_span + 15) / 16), lane);
          if (lane == 0) bounds[warp] = bound;
        }
      } else {
        const int gs = max(1, (n_build + COARSE - 1) / COARSE);
        const int gn = (n_build + gs - 1) / gs;
        stage(ring, 0, -1, build, 0, gs, gn);
        __syncthreads();
        if (warp < 2) {
          // ring[i - 1] = build[(i - 1) gs] < key <= build[i gs]
          const int i = warp_count_below([&](int x) { return ring[x]; }, gn,
                                         warp == 0 ? tmin : tmax, lane);
          const int bound = warp == 0 ? (i == 0 ? 0 : (i - 1) * gs + 1) : min(i * gs, n_build);
          if (lane == 0) bounds[warp] = bound;
        }
        if (tid == 0) tile_hi = -1;
      }
      __syncthreads();
      lo = bounds[0];
      hi = bounds[1];
      // the range itself into the ring, or a sampled index of it
      stride = hi - lo <= RING ? 1 : (hi - lo + SAMPLE - 1) / SAMPLE;
      cnt = (hi - lo + stride - 1) / stride;
      stage(ring, stride == 1 ? lo : 0, stride == 1 ? MASK : -1, build, lo, stride, cnt);
      issued = issued1 = issued2 = hi;
      __syncthreads();
    }
    // the next keys of the build column into the ring, behind the ones this
    // tile reads: build[issued, lo + RING); after a sample or a coarse
    // bracket, none
    last_max = tmax;
    last_hi = hi;
    last_span = hi - lo;
    if (stride == 1 && !coarse && t + 1 < t1) {
      const int end = static_cast<int>(min(static_cast<long long>(lo) + RING,
                                           static_cast<long long>(n_build)));
      for (int g = issued + tid; g < end; g += THREADS) cp_async_key(ring + (g & MASK), build + g);
      issued = max(issued, end);
    }
    cp_async_commit();
    issued2 = issued1;
    issued1 = issued;

    int res[PER];
    if (stride == 1) {
      // merge the run against build[lo, hi), held in the ring
      int g = lo;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const K k = keys[j];
        if (j > 0 && k >= keys[j - 1]) {
          const int lim = min(g + WALK, hi);
          while (g < lim && ring[g & MASK] < k) ++g;
          if (g == lim && lim < hi) g = lim + count_below(in_ring(lim), hi - lim, k);
        } else {
          g = lo + count_below(in_ring(lo), hi - lo, k);
        }
        res[j] = g;
      }
    } else {
      // the sample, then the keys between two samples, in lockstep
      int at[PER], len[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = count_below([&](int x) { return ring[x]; }, cnt, keys[j]);
        // ring[i - 1] < key <= ring[i] (or hi when i == cnt)
        at[j] = i == 0 ? lo : lo + (i - 1) * stride + 1;
        len[j] = i == 0 ? 0 : min(lo + i * stride, hi) - at[j];
      }
      bool more = true;
      while (more) {
        more = false;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (len[j] > 1) {
            const int half = len[j] >> 1;
            if (build[at[j] + half - 1] < keys[j]) at[j] += half;
            len[j] -= half;
            more = true;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) res[j] = at[j] + (len[j] == 1 && build[at[j]] < keys[j]);
    }
    if (coarse) {  // the tile's last bound, for the next tile
      int top = -1;
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (j < valid) top = max(top, res[j]);
      top = __reduce_max_sync(FULL, top);
      if (lane == 0) atomicMax(&tile_hi, top);
    }
    if (PER % 4 == 0 && valid == PER) {
#pragma unroll
      for (int q = 0; q < PER / 4; ++q)
        __stcs(reinterpret_cast<int4*>(out + first) + q,
               make_int4(res[4 * q], res[4 * q + 1], res[4 * q + 2], res[4 * q + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (j < valid) out[first + j] = res[j];
    }
  }
  cp_async_wait_all();
}

static const KernelInstance INSTANCES[] = {
    {(const void*)lower_bound_kernel<int, 8>, "lower_bound<4, 8>"},
    {(const void*)lower_bound_kernel<int, 4>, "lower_bound<4, 4>"},
    {(const void*)lower_bound_kernel<int, 2>, "lower_bound<4, 2>"},
    {(const void*)lower_bound_kernel<int, 1>, "lower_bound<4, 1>"},
    {(const void*)lower_bound_kernel<long long, 8>, "lower_bound<8, 8>"},
    {(const void*)lower_bound_kernel<long long, 4>, "lower_bound<8, 4>"},
    {(const void*)lower_bound_kernel<long long, 2>, "lower_bound<8, 2>"},
    {(const void*)lower_bound_kernel<long long, 1>, "lower_bound<8, 1>"}};
EXPORT_INSTANCES(lower_bound)

// the grid of one instance: as many blocks as fill the card (found, and the
// kernel's shared-memory limit raised, once per instance and card), and no
// more than the tiles
template <typename K, int PER>
static cudaError_t grid_config(long long n_probe, LaunchConfig* c) {
  constexpr int TILE = THREADS * PER;
  c->smem = RING_BYTES + 2 * TILE * sizeof(K);
  static Fill cache[MAX_DEVICES] = {};
  Fill fill;
  const cudaError_t err = grid_fill(lower_bound_kernel<K, PER>, THREADS, c->smem, cache, &fill);
  if (err != cudaSuccess) return err;
  c->per_sm = fill.per_sm;
  const long long tiles = (n_probe + TILE - 1) / TILE;
  const long long cap = static_cast<long long>(fill.sms) * fill.per_sm;
  c->grid = tiles < cap ? tiles : cap;
  return cudaSuccess;
}

// The launch of one call: the instance of the key's width and of the widest
// tile (2048 keys, 256 at the least) that leaves at least two tiles per SM;
// THREADS threads a block, the ring and two tiles of keys in dynamic shared
// memory.
static cudaError_t config(long long n_probe, int key_bytes, LaunchConfig* c) {
  if (n_probe < 1) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = 2LL * c->sms;
  const int per_branch = n_probe >= want * THREADS * 8   ? 0
                         : n_probe >= want * THREADS * 4 ? 1
                         : n_probe >= want * THREADS * 2 ? 2
                                                         : 3;
  c->instance = 4 * (key_bytes == 8) + per_branch;
  c->threads = THREADS;
  switch (c->instance) {
    case 0: return grid_config<int, 8>(n_probe, c);
    case 1: return grid_config<int, 4>(n_probe, c);
    case 2: return grid_config<int, 2>(n_probe, c);
    case 3: return grid_config<int, 1>(n_probe, c);
    case 4: return grid_config<long long, 8>(n_probe, c);
    case 5: return grid_config<long long, 4>(n_probe, c);
    case 6: return grid_config<long long, 2>(n_probe, c);
    default: return grid_config<long long, 1>(n_probe, c);
  }
}

extern "C" int lower_bound_launch_config(long long n_probe, int key_bytes, int device,
                                         long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(n_probe, key_bytes, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

template <typename K, int PER>
static void launch(const LaunchConfig& c, const void* build, int n_build, const void* probe,
                   long long n_probe, void* out, cudaStream_t stream) {
  constexpr int TILE = THREADS * PER;
  const bool aligned = reinterpret_cast<size_t>(probe) % 16 == 0;
  lower_bound_kernel<K, PER><<<static_cast<unsigned>(c.grid), c.threads, c.smem, stream>>>(
      static_cast<const K*>(build), n_build, static_cast<const K*>(probe), n_probe,
      (n_probe + TILE - 1) / TILE, aligned, static_cast<int*>(out));
}

// build (n_build,) and probe (n_probe,) of one key type, int32 or int64
// (key_bytes 4 or 8), build sorted ascending; n_build < 2^31, n_probe >= 1
// -> out (n_probe,) int32, 16-byte aligned.
extern "C" int lower_bound(const void* build, int n_build, const void* probe, long long n_probe,
                           int key_bytes, void* out, void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(n_probe, key_bytes, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c.instance) {
    case 0: launch<int, 8>(c, build, n_build, probe, n_probe, out, st); break;
    case 1: launch<int, 4>(c, build, n_build, probe, n_probe, out, st); break;
    case 2: launch<int, 2>(c, build, n_build, probe, n_probe, out, st); break;
    case 3: launch<int, 1>(c, build, n_build, probe, n_probe, out, st); break;
    case 4: launch<long long, 8>(c, build, n_build, probe, n_probe, out, st); break;
    case 5: launch<long long, 4>(c, build, n_build, probe, n_probe, out, st); break;
    case 6: launch<long long, 2>(c, build, n_build, probe, n_probe, out, st); break;
    default: launch<long long, 1>(c, build, n_build, probe, n_probe, out, st); break;
  }
  return launch_status();
}
