// GATHER for GFTR materialization: out[i] = idx[i] >= 0 ? src[min(idx[i], n_src - 1)] : 0,
// for elements of 4 or 8 bytes (the bits are copied, so any such dtype works).
//
// Replaces: src/repro/kernels/gather.py, gather_windowed_pallas
// (_gather_kernel), which stages a 2W window of src in VMEM per tile and
// resolves the gather as a one-hot matmul (with a 16-bit hi/lo split for
// integers) because the TPU has no fast per-lane random load.
//
// What bounds it: bytes. Each index is read once (4 B), each output written
// once; the source reads are clustered (GFTR's point), so neighbouring
// outputs read the same or neighbouring lines, and the source is read about
// once from device memory.
//
// Design: persistent blocks (as many as fit on the SMs) walk the output in
// warp steps of 32 x V outputs, V = 8. In a step, lane l owns V / P pieces of
// P = 16 / sizeof(T) consecutive outputs, piece g at 32 P g + P l, so each
// load of indices and each 16-byte store of a warp covers one contiguous
// span. A lane loads all of its V indices (vector loads where aligned)
// before it uses any. The warp then takes the step's source window, from its
// smallest index to its largest (after clamping), by a min and max across
// the lanes: when it holds at most WINDOW rows, the warp copies it into
// shared memory with coalesced loads (all of a lane's loads issued before
// its stores) and reads its outputs from there; otherwise each lane issues
// its V source loads directly, before it uses any. The index and output
// streams bypass L1 and are evicted first (__ldcs / __stcs). Outputs before
// the first 16-byte boundary of out and after the last whole step are
// copied one by one. Every index is clamped as the plain version clamps it,
// so the kernel is right for any index and needs no span check.
//
// Measured against each other in pairs (PERF.md): the window beat the direct
// loads on J2's build-side map by a median 1.9% and was level on the probe
// side; 16 outputs a lane and plain (not streaming) stores were no faster.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int V = 8;          // outputs per lane per step
constexpr int STEP = 32 * V;  // outputs per warp per step
constexpr int WINDOW = 256;   // source rows a warp stages per step

template <typename T>
__device__ __forceinline__ T fetch(const T* __restrict__ src, long long n_src, int j) {
  return j >= 0 ? __ldg(src + (j < n_src ? j : n_src - 1)) : T(0);
}

__device__ __forceinline__ void store16(unsigned* p, const unsigned* x) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(x[0], x[1], x[2], x[3]));
}
__device__ __forceinline__ void store16(unsigned long long* p, const unsigned long long* x) {
  __stcs(reinterpret_cast<ulonglong2*>(p), make_ulonglong2(x[0], x[1]));
}

// indices of one piece: P of them from idx + i
template <int P, bool VEC_IDX>
__device__ __forceinline__ void load_piece(const int* __restrict__ idx, long long i, int* j) {
  if (VEC_IDX && P == 4) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(idx + i));
    j[0] = a.x;
    j[1] = a.y;
    j[2] = a.z;
    j[3] = a.w;
  } else if (VEC_IDX && P == 2) {
    const int2 a = __ldcs(reinterpret_cast<const int2*>(idx + i));
    j[0] = a.x;
    j[1] = a.y;
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) j[p] = __ldcs(idx + i + p);
  }
}

template <typename T, bool VEC_IDX>
__global__ void __launch_bounds__(THREADS)
clustered_gather_kernel(const T* __restrict__ src, const int* __restrict__ idx, long long n_src,
                        long long n, int head, T* __restrict__ out) {
  constexpr int P = 16 / sizeof(T);  // outputs per 16-byte store
  constexpr int G = V / P;           // pieces per lane per step
  __shared__ T windows[THREADS / 32][WINDOW];
  T* win = windows[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const long long gtid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long steps = (n - head) / STEP;
  const long long tail = head + steps * STEP;
  // the scalar head and tail
  if (gtid < head) out[gtid] = fetch(src, n_src, idx[gtid]);
  if (gtid < n - tail) out[tail + gtid] = fetch(src, n_src, idx[tail + gtid]);

  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  for (long long s = gtid >> 5; s < steps; s += warps) {
    const long long at = head + s * STEP + P * lane;
    int j[V];
#pragma unroll
    for (int g = 0; g < G; ++g) load_piece<P, VEC_IDX>(idx, at + 32 * P * g, j + P * g);
    // the step's window: rows [lo, hi] of the clamped valid indices
    int lo = INT32_MAX, hi = -1;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (j[v] >= 0) {
        j[v] = j[v] < n_src ? j[v] : static_cast<int>(n_src - 1);
        lo = min(lo, j[v]);
        hi = max(hi, j[v]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    T x[V];
    if (hi >= lo && hi - lo < WINDOW) {  // the same branch for the whole warp
      const int rows = hi - lo + 1;
      for (int r0 = 0; r0 < rows; r0 += 4 * 32) {
        T r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r0 + u * 32 + lane < rows) r[u] = __ldg(src + lo + r0 + u * 32 + lane);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r0 + u * 32 + lane < rows) win[r0 + u * 32 + lane] = r[u];
      }
      __syncwarp();
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = j[v] >= 0 ? win[j[v] - lo] : T(0);
      __syncwarp();  // the next step's window may overwrite this one
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = fetch(src, n_src, j[v]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) store16(out + at + 32 * P * g, x + P * g);
  }
}

static const KernelInstance INSTANCES[] = {
    {(const void*)clustered_gather_kernel<unsigned, false>, "clustered_gather<4, false>"},
    {(const void*)clustered_gather_kernel<unsigned, true>, "clustered_gather<4, true>"},
    {(const void*)clustered_gather_kernel<unsigned long long, false>,
     "clustered_gather<8, false>"},
    {(const void*)clustered_gather_kernel<unsigned long long, true>, "clustered_gather<8, true>"}};
EXPORT_INSTANCES(clustered_gather)

// outputs before out's first 16-byte boundary, copied one by one
static long long head_of(const void* out, long long n, int elem_bytes) {
  return std::min(
      static_cast<long long>((16 - reinterpret_cast<uintptr_t>(out) % 16) % 16 / elem_bytes), n);
}

// the grid of one instance: as many blocks as fill the card (found once per
// instance and card), and no more than the warp steps and the scalar head
// and tail need
template <typename T, bool VEC_IDX>
static cudaError_t grid_config(long long n, long long head, LaunchConfig* c) {
  static Fill cache[MAX_DEVICES] = {};
  Fill fill;
  const cudaError_t err = grid_fill(clustered_gather_kernel<T, VEC_IDX>, THREADS, 0, cache, &fill);
  if (err != cudaSuccess) return err;
  c->sms = fill.sms;
  c->per_sm = fill.per_sm;
  const long long need = std::max(((n - head) / STEP * 32 + THREADS - 1) / THREADS,
                                  static_cast<long long>(STEP + THREADS - 1) / THREADS);
  c->grid = std::min(need, static_cast<long long>(fill.sms) * fill.per_sm);
  return cudaSuccess;
}

// The launch of one call: the instance of the element size, with vector
// index loads when idx + head lies on a (4 P)-byte boundary; THREADS
// threads a block, a window of static shared memory a warp.
static cudaError_t config(const void* idx, long long n, int elem_bytes, const void* out,
                          LaunchConfig* c) {
  if (n < 1 || (elem_bytes != 4 && elem_bytes != 8)) return cudaErrorInvalidValue;
  const long long head = head_of(out, n, elem_bytes);
  const int P = 16 / elem_bytes;
  const bool vec = (reinterpret_cast<uintptr_t>(idx) + 4 * head) % (4 * P) == 0;
  c->instance = 2 * (elem_bytes == 8) + vec;
  c->threads = THREADS;
  c->smem = 0;
  switch (c->instance) {
    case 0: return grid_config<unsigned, false>(n, head, c);
    case 1: return grid_config<unsigned, true>(n, head, c);
    case 2: return grid_config<unsigned long long, false>(n, head, c);
    default: return grid_config<unsigned long long, true>(n, head, c);
  }
}

extern "C" int clustered_gather_launch_config(const void* idx, long long n, int elem_bytes,
                                              const void* out, int device, long long* out_cfg) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(idx, n, elem_bytes, out, &c);
  put_config(c, out_cfg);
  return static_cast<int>(err);
}

template <typename T, bool VEC_IDX>
static void launch(const LaunchConfig& c, const void* src, const void* idx, long long n_src,
                   long long n, void* out, cudaStream_t stream) {
  clustered_gather_kernel<T, VEC_IDX><<<static_cast<unsigned>(c.grid), c.threads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const int*>(idx), n_src, n,
      static_cast<int>(head_of(out, n, sizeof(T))), static_cast<T*>(out));
}

// elem_bytes is 4 or 8; idx is int32; src has n_src >= 1 elements; n >= 1.
extern "C" int clustered_gather(const void* src, const void* idx, long long n_src, long long n,
                                int elem_bytes, void* out, void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(idx, n, elem_bytes, out, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  switch (c.instance) {
    case 0: launch<unsigned, false>(c, src, idx, n_src, n, out, s); break;
    case 1: launch<unsigned, true>(c, src, idx, n_src, n, out, s); break;
    case 2: launch<unsigned long long, false>(c, src, idx, n_src, n, out, s); break;
    default: launch<unsigned long long, true>(c, src, idx, n_src, n, out, s); break;
  }
  return launch_status();
}
