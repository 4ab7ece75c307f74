// Partition digits of join keys, one int32 per row:
//   out[i] = keys[i] == KEY_SENTINEL ? 1 << p_bits : h(keys[i]) & (2^p_bits - 1),
// where h is the Murmur3-style finalizer hash32 of the key's 32 bits (an
// 8-byte key folded first: its low word ^ its high word) or, where hash is
// 0, the key's low 32 bits. Keys are int32 or int64.
//
// Replaces: nothing of the JAX package's kernels. src/repro/core/hash_join.py
// (_digits, hash32) is one XLA fusion there; in eager PyTorch it was a chain
// of ~24 elementwise passes over int64 copies of the keys (uint32 arithmetic
// done in int64, each multiply split into 16-bit halves), ~400 bytes of
// device traffic a row. Its plain version is kernels/ref.py's.
//
// What bounds it: bytes. Each key is read once and each digit written once:
// 8 bytes a row for int32 keys, 12 for int64. The arithmetic is a few
// integer operations a row, in registers, with uint32 wrap-around.
//
// Design: a single streaming pass. A block takes THREADS x ROWS rows, and
// a thread U 16-byte vectors of digits (four rows each) of them, issuing
// all of their loads before any store, so enough bytes are in flight on
// each SM. Digits before out's first 16-byte boundary and after the last
// whole vector are written one by one. Where the keys at that boundary are
// not on a 16-byte boundary of their own (a view that starts 1-3 elements
// into a column), the scalar instance reads and writes every row one by
// one, still coalesced across a warp. Keys and digits are streamed (__ldcs /
// __stcs): nothing is read twice.
//
// Measured against each other on an H100 80GB HBM3 at 700 W (PERF.md): a
// block for every 4,096 rows ran 0.190 ms at 2^26 int32 keys, 84% of the
// bytes bound, where torch's copy_ of the same bytes ran 0.186 ms; a grid
// capped at the card's fill that walked the rows in strides 0.199 ms; 1, 2
// or 8 vectors a thread, 512 threads a block and plain loads or stores
// were no faster.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int U = 4;  // 16-byte vectors of digits a thread
constexpr int ROWS = 4 * U;  // rows a thread

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// the 32 bits the hash takes: an 8-byte key's low word ^ its high word
__device__ __forceinline__ unsigned fold(int k) { return static_cast<unsigned>(k); }
__device__ __forceinline__ unsigned fold(long long k) {
  return static_cast<unsigned>(k) ^ static_cast<unsigned>(k >> 32);
}

template <typename K>
__device__ __forceinline__ int digit(K k, bool hash, int p_bits, unsigned mask) {
  if (k == static_cast<K>(KEY_SENTINEL)) return 1 << p_bits;
  const unsigned h = hash ? hash32(fold(k)) : static_cast<unsigned>(k);
  return static_cast<int>(h & mask);
}

// four keys from a 16-byte-aligned address: one vector of int32 keys, two
// of int64 keys
__device__ __forceinline__ void load4(const int* p, int* k) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  k[0] = a.x;
  k[1] = a.y;
  k[2] = a.z;
  k[3] = a.w;
}
__device__ __forceinline__ void load4(const long long* p, long long* k) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p + 2));
  k[0] = a.x;
  k[1] = a.y;
  k[2] = b.x;
  k[3] = b.y;
}

template <typename K, bool VEC>
__global__ void __launch_bounds__(THREADS)
partition_digits_kernel(const K* __restrict__ keys, long long n, int head, int hash, int p_bits,
                        int* __restrict__ out) {
  const unsigned mask = (1u << p_bits) - 1u;
  const bool h = hash != 0;
  if (!VEC) {
    // every row one by one: a warp's loads and stores cover 32 neighbours
    const long long i0 = static_cast<long long>(blockIdx.x) * THREADS * ROWS + threadIdx.x;
    K k[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (i0 + j * THREADS < n) k[j] = __ldcs(keys + i0 + j * THREADS);
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (i0 + j * THREADS < n) __stcs(out + i0 + j * THREADS, digit(k[j], h, p_bits, mask));
    return;
  }
  const long long vecs = (n - head) / 4;
  const long long tail = head + 4 * vecs;
  // the scalar head and tail, by block 0's first threads
  if (blockIdx.x == 0 && threadIdx.x < head)
    out[threadIdx.x] = digit(keys[threadIdx.x], h, p_bits, mask);
  if (blockIdx.x == 0 && threadIdx.x < n - tail)
    out[tail + threadIdx.x] = digit(keys[tail + threadIdx.x], h, p_bits, mask);
  const K* kv = keys + head;
  int* ov = out + head;
  const long long v0 = static_cast<long long>(blockIdx.x) * THREADS * U + threadIdx.x;
  K k[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (v0 + u * THREADS < vecs) load4(kv + 4 * (v0 + u * THREADS), k[u]);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (v0 + u * THREADS < vecs)
      __stcs(reinterpret_cast<int4*>(ov + 4 * (v0 + u * THREADS)),
             make_int4(digit(k[u][0], h, p_bits, mask), digit(k[u][1], h, p_bits, mask),
                       digit(k[u][2], h, p_bits, mask), digit(k[u][3], h, p_bits, mask)));
}

static const KernelInstance INSTANCES[] = {
    {(const void*)partition_digits_kernel<int, false>, "partition_digits<4, false>"},
    {(const void*)partition_digits_kernel<int, true>, "partition_digits<4, true>"},
    {(const void*)partition_digits_kernel<long long, false>, "partition_digits<8, false>"},
    {(const void*)partition_digits_kernel<long long, true>, "partition_digits<8, true>"}};
EXPORT_INSTANCES(partition_digits)

// digits before out's first 16-byte boundary, written one by one
static long long head_of(const void* out, long long n) {
  return std::min(static_cast<long long>((16 - reinterpret_cast<uintptr_t>(out) % 16) % 16 / 4),
                  n);
}

// The launch of one call: the instance of the key width, vector loads and
// stores where the keys at out's first 16-byte boundary lie on one of
// their own; THREADS threads a block, no shared memory, a block for every
// THREADS x ROWS rows (of the vector instance's whole vectors) and at least
// one. The grid is the work's, not the card's: sms and per_sm stay 0.
static cudaError_t config(const void* keys, long long n, int key_bytes, const void* out,
                          LaunchConfig* c) {
  if (n < 1 || (key_bytes != 4 && key_bytes != 8)) return cudaErrorInvalidValue;
  const long long head = head_of(out, n);
  const bool vec = (reinterpret_cast<uintptr_t>(keys) + key_bytes * head) % 16 == 0;
  const long long rows = vec ? (n - head) / 4 * 4 : n;
  const long long per_block = static_cast<long long>(THREADS) * ROWS;
  c->instance = 2 * (key_bytes == 8) + vec;
  c->threads = THREADS;
  c->smem = 0;
  c->grid = std::max((rows + per_block - 1) / per_block, 1LL);
  return cudaSuccess;
}

extern "C" int partition_digits_launch_config(const void* keys, long long n, int key_bytes,
                                              const void* out, int device, long long* out_cfg) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(keys, n, key_bytes, out, &c);
  put_config(c, out_cfg);
  return static_cast<int>(err);
}

template <typename K, bool VEC>
static void launch(const LaunchConfig& c, const void* keys, long long n, int hash, int p_bits,
                   void* out, cudaStream_t stream) {
  partition_digits_kernel<K, VEC><<<static_cast<unsigned>(c.grid), c.threads, 0, stream>>>(
      static_cast<const K*>(keys), n, static_cast<int>(head_of(out, n)), hash, p_bits,
      static_cast<int*>(out));
}

// key_bytes is 4 or 8; p_bits in [0, 30]; hash 0 takes the keys' low 32
// bits as they are; n >= 1.
extern "C" int partition_digits(const void* keys, long long n, int key_bytes, int p_bits,
                                int hash, void* out, void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  if (p_bits < 0 || p_bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  LaunchConfig c;
  const cudaError_t err = config(keys, n, key_bytes, out, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  switch (c.instance) {
    case 0: launch<int, false>(c, keys, n, hash, p_bits, out, s); break;
    case 1: launch<int, true>(c, keys, n, hash, p_bits, out, s); break;
    case 2: launch<long long, false>(c, keys, n, hash, p_bits, out, s); break;
    default: launch<long long, true>(c, keys, n, hash, p_bits, out, s); break;
  }
  return launch_status();
}
