// Co-partition probe of the partitioned hash join (PHJ match finding), over
// the partitioned build and probe columns as the partition plans leave them.
// For each probe row j of partition p (rows [probe_off[p], probe_off[p] +
// probe_sz[p])), the first slot s among the first min(sz_r[p], cap) build
// rows of partition p (rows off_r[p] + s) whose key equals the probe key:
//   vid = off_r[p] + s, hit = 1   or   vid = -1, hit = 0.
// KEY_SENTINEL keys never match; probe rows that lie in no partition (the
// sentinel partition's rows past partition P - 1) miss.
//
// Replaces: src/repro/kernels/hash_probe.py, hash_probe_pallas
// (_probe_kernel), which compares a (capS x capR) equality matrix of a padded
// probe sub-block and a padded build block on the TPU's vector unit and
// takes an iota-min over it. The padded layouts were what the TPU's blocks
// needed; this kernel reads neither.
//
// What bounds it: bytes. Each probe key is read once and its vid (4 B) and
// hit (1 B) written once; each live build key and both sides' offsets and
// sizes are read once. The lookups are one or two shared-memory probes a row.
//
// Design: persistent blocks; a group of threads (a warp for blocks of up to
// WARP_CAP keys, the whole block for wider ones) owns one partition at a
// time and walks the partitions with a stride of all groups. It stages the
// partition's live build keys into an open-addressing table in its own
// shared memory, at least twice as many entries as keys, each entry one
// 64-bit word (slot << 32 | key) so that a probe is one shared load. The
// index is the top bits of the key times 2^32 / phi, a multiplicative hash
// of the key's bits: PHJ's partition digit is the low bits of a mix of the
// key, and keys of one partition still spread over the table. Equal keys
// share an entry, which keeps the atomicMin of their words: the first slot
// wins whatever the order of the atomics. The group then streams the
// partition's probe rows, four a thread in flight with their first probes
// issued together, and writes vid and the 1-byte hit.
// The next partition's offsets and sizes are loaded before the current one
// is probed.
//
// What held it back (H100 80GB HBM3, 700 W; PERF.md): walking the
// partitions. With no table at all, the same loads and stores take 0.34 of
// the kernel's 0.43 ms at J2; more rows in flight (in registers or staged by
// cp.async), runs of neighbouring partitions per warp, 16-byte rows a thread
// and the next build block copied ahead each moved it by less than 5%, most
// of them the wrong way.
#include "common.cuh"

constexpr int THREADS = 256;
// the widest build block one warp's table takes: 2 * 256 entries of 8 bytes
constexpr int WARP_CAP = 256;
constexpr int WARP_TABLE_BITS = 9;
// a block's table for wider build blocks: 16,384 entries (128 KB), more
// than the widest build block the wrapper takes (12,288)
constexpr int BLOCK_TABLE_BITS = 14;
// probe rows a thread has in flight
constexpr int UNROLL = 4;

// an empty table entry: no key is KEY_SENTINEL in a live entry
constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ unsigned slot_hash(int key, int bits) {
  return (static_cast<unsigned>(key) * 0x9E3779B1u) >> (32 - bits);
}

// the rows one partition's group answers: [lo, hi), of which [start,
// probe_hi) are the partition's probe rows and the rest lie in no partition
// (partition 0 answers the rows before its first, every partition those up
// to the next one's first, the last those up to n_probe)
struct Part {
  int build_off, build_rows;
  long long lo, start, probe_hi, hi;
};

__device__ __forceinline__ Part load_part(long long p, const int* __restrict__ off_r,
                                          const int* __restrict__ sz_r,
                                          const int* __restrict__ off_s,
                                          const int* __restrict__ sz_s, int num_parts,
                                          long long n_probe, int cap) {
  Part q;
  q.build_off = off_r[p];
  q.build_rows = max(0, min(sz_r[p], cap));
  q.start = min(max(static_cast<long long>(off_s[p]), 0LL), n_probe);
  q.probe_hi = min(q.start + max(sz_s[p], 0), n_probe);
  const long long next =
      p + 1 < num_parts ? min(static_cast<long long>(off_s[p + 1]), n_probe) : n_probe;
  q.lo = p == 0 ? 0 : q.start;
  q.hi = max(next, q.probe_hi);
  return q;
}

template <int GROUP>
__device__ __forceinline__ void group_sync() {
  if constexpr (GROUP == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int GROUP>
__global__ void __launch_bounds__(THREADS) hash_probe_kernel(
    const int* __restrict__ build, const int* __restrict__ off_r, const int* __restrict__ sz_r,
    const int* __restrict__ probe, const int* __restrict__ off_s, const int* __restrict__ sz_s,
    int num_parts, long long n_probe, int cap, int table_bits, int* __restrict__ vid,
    unsigned char* __restrict__ hit) {
  constexpr int GROUPS = THREADS / GROUP;
  extern __shared__ __align__(16) unsigned long long table_mem[];
  const int g = threadIdx.x / GROUP, r = threadIdx.x % GROUP;
  unsigned long long* table = table_mem + (static_cast<long long>(g) << table_bits);
  const long long stride = static_cast<long long>(gridDim.x) * GROUPS;
  long long p = static_cast<long long>(blockIdx.x) * GROUPS + g;
  if (p >= num_parts) return;  // the whole group leaves: no sync is left waiting
  Part cur = load_part(p, off_r, sz_r, off_s, sz_s, num_parts, n_probe, cap);
  for (; p < num_parts; p += stride) {
    const long long pn = p + stride;
    Part nxt{};
    if (pn < num_parts) nxt = load_part(pn, off_r, sz_r, off_s, sz_s, num_parts, n_probe, cap);
    const int m = cur.build_rows;
    // the smallest table of at least 2m entries (at least 2)
    int bits = 1;
    while ((1 << bits) < 2 * m && bits < table_bits) ++bits;
    const unsigned mask = (1u << bits) - 1;
    for (int i = r; i <= static_cast<int>(mask); i += GROUP) table[i] = EMPTY;
    group_sync<GROUP>();
    for (int s = r; s < m; s += GROUP) {
      const int k = build[static_cast<long long>(cur.build_off) + s];
      if (k == KEY_SENTINEL) continue;
      const unsigned long long word =
          (static_cast<unsigned long long>(s) << 32) | static_cast<unsigned>(k);
      unsigned h = slot_hash(k, bits);
      while (true) {
        const unsigned long long old = atomicCAS(&table[h], EMPTY, word);
        if (old == EMPTY) break;
        if (static_cast<int>(old) == k) {  // a repeated key keeps its first slot
          atomicMin(&table[h], word);
          break;
        }
        h = (h + 1) & mask;
      }
    }
    group_sync<GROUP>();
    for (long long j0 = cur.lo + r; j0 < cur.hi; j0 += UNROLL * GROUP) {
      int keys[UNROLL];
      unsigned h[UNROLL];
      unsigned long long e[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = j0 + u * GROUP;
        keys[u] = j >= cur.start && j < cur.probe_hi ? probe[j] : KEY_SENTINEL;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        h[u] = slot_hash(keys[u], bits);
        e[u] = table[h[u]];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = j0 + u * GROUP;
        if (j >= cur.hi) break;
        const int key = keys[u];
        int slot = -1;
        if (key != KEY_SENTINEL) {
          unsigned long long x = e[u];
          while (x != EMPTY && static_cast<int>(x) != key) {
            h[u] = (h[u] + 1) & mask;
            x = table[h[u]];
          }
          if (x != EMPTY) slot = static_cast<int>(x >> 32);
        }
        vid[j] = slot >= 0 ? cur.build_off + slot : -1;
        hit[j] = slot >= 0;
      }
    }
    group_sync<GROUP>();  // every lookup is done before the table is cleared
    cur = nxt;
  }
}

template <int GROUP, int TABLE_BITS>
static int launch(const int* build, const int* off_r, const int* sz_r, const int* probe,
                  const int* off_s, const int* sz_s, int num_parts, long long n_probe, int cap,
                  int* vid, unsigned char* hit, cudaStream_t stream) {
  constexpr int GROUPS = THREADS / GROUP;
  constexpr size_t smem = static_cast<size_t>(GROUPS) * (2 << TABLE_BITS) * sizeof(int);
  auto kernel = hash_probe_kernel<GROUP>;
  static long long cache[MAX_DEVICES] = {};
  long long fill = 0;
  const cudaError_t err = grid_fill(kernel, THREADS, smem, cache, &fill);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (num_parts + GROUPS - 1) / GROUPS;
  kernel<<<static_cast<unsigned>(want < fill ? want : fill), THREADS, smem, stream>>>(
      build, off_r, sz_r, probe, off_s, sz_s, num_parts, n_probe, cap, TABLE_BITS, vid, hit);
  return launch_status();
}

// build (n_build,) int32 keys in partition order, off_r and sz_r (num_parts,)
// int32; probe (n_probe,) int32 keys in partition order, off_s and sz_s
// (num_parts,) int32, partitions in row order and not overlapping;
// 1 <= cap <= 12288, num_parts >= 1, n_probe >= 1 -> vid (n_probe,) int32,
// hit (n_probe,) 0/1 bytes.
extern "C" int hash_probe(const void* build, const void* off_r, const void* sz_r,
                          const void* probe, const void* off_s, const void* sz_s, int num_parts,
                          long long n_probe, int cap, void* vid, void* hit, void* stream,
                          int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  // a table keeps at least one empty entry, so every lookup ends
  if (cap < 1 || cap >= (1 << BLOCK_TABLE_BITS)) return static_cast<int>(cudaErrorInvalidValue);
  auto b = static_cast<const int*>(build);
  auto orr = static_cast<const int*>(off_r);
  auto szr = static_cast<const int*>(sz_r);
  auto pr = static_cast<const int*>(probe);
  auto os = static_cast<const int*>(off_s);
  auto szs = static_cast<const int*>(sz_s);
  auto v = static_cast<int*>(vid);
  auto h = static_cast<unsigned char*>(hit);
  auto st = static_cast<cudaStream_t>(stream);
  if (cap <= WARP_CAP)
    return launch<32, WARP_TABLE_BITS>(b, orr, szr, pr, os, szs, num_parts, n_probe, cap, v, h,
                                       st);
  return launch<THREADS, BLOCK_TABLE_BITS>(b, orr, szr, pr, os, szs, num_parts, n_probe, cap, v,
                                           h, st);
}
