// One LSD pass's move of the partition planner: by the pass's destinations
// dest (a permutation of [0, n), from the rank kernel),
//   perm_out[dest[i]] = perm_in[i]  (i itself on a first pass: perm_in null)
//   dig_out[dest[i]]  = dig_in[i]
// so the running permutation and the keys it orders travel together, and
// after the last pass dig_out holds the keys sorted.
//
// Replaces no TPU kernel. The JAX package composes its passes by gathering
// each pass's digits through the composed permutation and folding the
// pass's destinations into it with XLA scatters. On the card those were
// ATen's index and index_put: a random 4-byte gather through a permutation
// scattered over the whole array (a 32-byte sector a row), and an int64
// copy of every int32 index first. This kernel does the pass's one scatter
// for both arrays and never gathers.
//
// What bounds it: bytes. dest, dig_in and perm_in read once (12 B a row, 8
// on a first pass), perm_out and dig_out written once (8 B): 20 B a row,
// 0.401 ms at 2^26 rows on 3.35 TB/s. Written row by row, a 256-bin pass's
// stores land one 4-byte word in each of 32 sectors a warp instruction, and
// the pass ran at a tenth of its bound on the H100 (PERF.md).
//
// Design: the stable partition sends each bin's rows of any run of
// consecutive rows to consecutive destinations. A block takes CHUNK = 8,192
// consecutive rows at a time (persistent blocks, one an SM), each thread
// PER of them, loaded as 16-byte vectors where dest, dig_in and perm_in lie
// on 16-byte boundaries (__ldcs: evicted first). Each row's bin is the
// pass's digit of its key (the shift and mask of the caller's pass, the
// tail class included). Shared memory counts each bin's rows in the chunk
// and keeps its least destination (an atomicAdd and an atomicMin a row; a
// warp whose rows share one bin, as the padding's sentinel rows do, makes
// one of each). An exclusive scan of the counts gives each bin its place in
// a staging buffer, and a row goes to its bin's place plus its
// destination's distance from the bin's least one: the buffer holds the
// chunk's rows (destination, permutation entry, key) in destination order
// within each bin. The block then writes the buffer out in order, so that
// consecutive threads store consecutive destinations, whole sectors at a
// time. Counts, minimums and the scan do not depend on the order the
// atomics land in. A chunk whose bin's destinations do not fill one run
// (bins other than the rank kernel's) is written row by row from registers,
// so the output comes from dest alone. A destination outside [0, n) (no
// rank gives one) writes nothing.
//
// Measured against each other at a 2^26-row plan's passes (PERF.md):
// staged by an atomic's rank instead, consecutive slots of a bin held rows
// about four destinations apart, and the stores ran as slowly as unstaged
// ones; chunks of 4,096 rows at two blocks an SM made a 256-bin pass's runs
// 16 rows long and took 1.18x as long over the plan's three passes; copying
// the next chunk in with cp.async while the block works on the current one
// gained nothing.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

constexpr int THREADS = 1024;
constexpr int PER = 8;                       // rows a thread holds; a multiple of 4
constexpr int CHUNK = THREADS * PER;         // rows a block stages at a time
constexpr int MAX_BITS = 8;                  // a pass's digit bits
constexpr int BINS = (1 << MAX_BITS) + 4;    // the counts' room: 256 bins, the tail, padding
constexpr int WARPS = THREADS / 32;
// shared memory: the staged destinations, permutation entries and keys, the
// counts, the least destinations, the offsets (and the chunk's total after
// them), the warps' partial sums and the row-by-row flag
constexpr int SMEM_WORDS = 3 * CHUNK + 3 * BINS + WARPS + 1;
constexpr unsigned FULL = 0xffffffffu;

static_assert(PER % 4 == 0, "rows a thread holds come in 16-byte groups");
static_assert((1 << MAX_BITS) + 2 <= THREADS, "the scan gives each bin and the total a thread");

// a row's bin: -1 where its destination lies outside [0, n) (or no row);
// else the pass's digit of its key: the tail class where tail_bin >= 0 and
// the key is the tail key, else `bits` bits of it from `shift`
__device__ __forceinline__ int bin_of(int dest, int key, long long n, int shift, int mask,
                                      int tail_key, int tail_bin) {
  if (dest < 0 || dest >= n) return -1;
  return tail_bin >= 0 && key == tail_key ? tail_bin : (key >> shift) & mask;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    pass_scatter_kernel(const int* __restrict__ dest, const int* __restrict__ dig_in,
                        const int* __restrict__ perm_in, long long n, int shift, int bits,
                        int tail_key, int has_tail, int* __restrict__ perm_out,
                        int* __restrict__ dig_out) {
  extern __shared__ int4 smem4[];
  int* s_dest = reinterpret_cast<int*>(smem4);
  int* s_perm = s_dest + CHUNK;
  int* s_key = s_perm + CHUNK;
  int* cnt = s_key + CHUNK;
  int* lo = cnt + BINS;    // each bin's least destination in the chunk
  int* off = lo + BINS;    // nb offsets, then the chunk's total
  int* wsum = off + BINS;  // WARPS exclusive sums
  int* direct = wsum + WARPS;  // set: write the chunk row by row
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mask = (1 << bits) - 1, tail_bin = has_tail ? 1 << bits : -1;
  const int nb = (1 << bits) + (has_tail ? 1 : 0);
  if (t < BINS) {
    cnt[t] = 0;
    lo[t] = INT32_MAX;
  }
  __syncthreads();
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long start = c * CHUNK;
    int d[PER], p[PER], k[PER];
#pragma unroll
    for (int g = 0; g < PER / 4; ++g) {
      // VEC: four consecutive rows a 16-byte group; else row g4 + e at a stride
      const long long row = VEC ? start + 4LL * (g * THREADS + t) : start + 4LL * g * THREADS + t;
      if (VEC && row + 4 <= n) {
        const int4 dv = __ldcs(reinterpret_cast<const int4*>(dest + row));
        const int4 kv = __ldcs(reinterpret_cast<const int4*>(dig_in + row));
        const int i = static_cast<int>(row);
        const int4 pv = perm_in != nullptr ? __ldcs(reinterpret_cast<const int4*>(perm_in + row))
                                           : make_int4(i, i + 1, i + 2, i + 3);
        d[4 * g] = dv.x, d[4 * g + 1] = dv.y, d[4 * g + 2] = dv.z, d[4 * g + 3] = dv.w;
        k[4 * g] = kv.x, k[4 * g + 1] = kv.y, k[4 * g + 2] = kv.z, k[4 * g + 3] = kv.w;
        p[4 * g] = pv.x, p[4 * g + 1] = pv.y, p[4 * g + 2] = pv.z, p[4 * g + 3] = pv.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long ri = VEC ? row + e : row + static_cast<long long>(e) * THREADS;
          const bool in = ri < n;
          d[4 * g + e] = in ? __ldcs(dest + ri) : -1;
          k[4 * g + e] = in ? __ldcs(dig_in + ri) : 0;
          p[4 * g + e] = in ? (perm_in != nullptr ? __ldcs(perm_in + ri) : static_cast<int>(ri))
                            : 0;
        }
      }
    }
    // each bin's rows and least destination in the chunk (bin -1: no row)
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int b = bin_of(d[j], k[j], n, shift, mask, tail_key, tail_bin);
      const int b0 = __shfl_sync(FULL, b, 0);
      if (__all_sync(FULL, b == b0)) {
        const int least = __reduce_min_sync(FULL, d[j]);
        if (lane == 0 && b0 >= 0) {
          atomicAdd(&cnt[b0], 32);
          atomicMin(&lo[b0], least);
        }
      } else if (b >= 0) {
        atomicAdd(&cnt[b], 1);
        atomicMin(&lo[b], d[j]);
      }
    }
    if (t == 0) *direct = 0;
    __syncthreads();
    // offsets: the exclusive scan of the counts, one bin a thread, the
    // chunk's total after them; the counts are cleared for the next chunk
    const int v = t < nb ? cnt[t] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < WARPS ? wsum[lane] : 0;
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += y;
      }
      if (lane < WARPS) wsum[lane] = wi - w;
    }
    __syncthreads();
    if (t <= nb) off[t] = wsum[warp] + incl - v;
    if (t < nb) cnt[t] = 0;
    __syncthreads();
    // stage each bin's rows in destination order; a row whose destination
    // lies past its bin's count sends the chunk row by row
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int b = bin_of(d[j], k[j], n, shift, mask, tail_key, tail_bin);
      if (b >= 0) {
        const int o = d[j] - lo[b];
        if (o < off[b + 1] - off[b]) {
          const int s = off[b] + o;
          s_dest[s] = d[j];
          s_perm[s] = p[j];
          s_key[s] = k[j];
        } else {
          *direct = 1;
        }
      }
    }
    __syncthreads();
    if (*direct) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (d[j] >= 0 && d[j] < n) {
          perm_out[d[j]] = p[j];
          dig_out[d[j]] = k[j];
        }
      }
    } else {
      const int m = off[nb];
      for (int s = t; s < m; s += THREADS) {
        const int q = s_dest[s];
        perm_out[q] = s_perm[s];
        dig_out[q] = s_key[s];
      }
    }
    if (t < nb) lo[t] = INT32_MAX;
    __syncthreads();  // the next chunk's counts, scan and staging reuse the buffers
  }
}

static const KernelInstance INSTANCES[] = {
    {(const void*)pass_scatter_kernel<false>, "pass_scatter<false>"},
    {(const void*)pass_scatter_kernel<true>, "pass_scatter<true>"}};
EXPORT_INSTANCES(pass_scatter)

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool VEC>
static cudaError_t grid_config(long long n, LaunchConfig* c) {
  static Fill cache[MAX_DEVICES] = {};
  Fill fill;
  const cudaError_t err =
      grid_fill(pass_scatter_kernel<VEC>, THREADS, c->smem, cache, &fill);
  if (err != cudaSuccess) return err;
  c->sms = fill.sms;
  c->per_sm = fill.per_sm;
  c->grid = std::min((n + CHUNK - 1) / CHUNK, static_cast<long long>(fill.sms) * fill.per_sm);
  return cudaSuccess;
}

// The launch of one call: the vector instance where dest, dig_in and
// perm_in (when given) lie on 16-byte boundaries; THREADS threads a block
// and SMEM_WORDS words of dynamic shared memory (the limit raised past 48
// KB); as many blocks as fill the card, and no more than one a chunk.
static cudaError_t config(const void* dest, const void* dig_in, const void* perm_in, long long n,
                          LaunchConfig* c) {
  if (n < 1) return cudaErrorInvalidValue;
  const bool vec = aligned16(dest) && aligned16(dig_in) && aligned16(perm_in);
  c->instance = vec;
  c->threads = THREADS;
  c->smem = static_cast<long long>(SMEM_WORDS) * sizeof(int);
  return vec ? grid_config<true>(n, c) : grid_config<false>(n, c);
}

extern "C" int pass_scatter_launch_config(const void* dest, const void* dig_in,
                                          const void* perm_in, long long n, int device,
                                          long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(dest, dig_in, perm_in, n, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

// dest, dig_in, perm_out, dig_out: (n,) int32; perm_in: (n,) int32 or null
// (a first pass); n in [1, 2^31); the pass's digit: bits in [0, MAX_BITS] of
// the key from shift in [0, 32), and the tail class where has_tail.
extern "C" int pass_scatter(const void* dest, const void* dig_in, const void* perm_in,
                            long long n, int shift, int bits, int tail_key, int has_tail,
                            void* perm_out, void* dig_out, void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  if (bits < 0 || bits > MAX_BITS || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  LaunchConfig c;
  const cudaError_t err = config(dest, dig_in, perm_in, n, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dest);
  const int* g = static_cast<const int*>(dig_in);
  const int* p = static_cast<const int*>(perm_in);
  int* po = static_cast<int*>(perm_out);
  int* go = static_cast<int*>(dig_out);
  if (c.instance)
    pass_scatter_kernel<true><<<static_cast<unsigned>(c.grid), c.threads, c.smem, s>>>(
        d, g, p, n, shift, bits, tail_key, has_tail, po, go);
  else
    pass_scatter_kernel<false><<<static_cast<unsigned>(c.grid), c.threads, c.smem, s>>>(
        d, g, p, n, shift, bits, tail_key, has_tail, po, go);
  return launch_status();
}
