// Fused probe + tile-local grouped aggregation of the group-join.
// For one probe sub-block b of cap_s rows, against its co-partition's build
// block (block_part[b]):
//   1. each row's first matching build slot (as hash_probe.cu);
//   2. its group key, masked to KEY_SENTINEL when the row did not match;
//   3. its slot: the lowest row of the sub-block with the same masked key;
//   4. per slot, the key, one float32 sum per aggregate column and an int32
//      count of the rows it owns, summed in row order; a slot that owns no
//      row gets KEY_SENTINEL and zeros.
// Column q reads the matched build value bvals[part, j, hit] when
// col_src[q] = -(j + 1), or the probe value pv[b, j, row] when col_src[q] = j.
//
// Replaces: src/repro/kernels/hash_probe.py, probe_agg_pallas
// (_probe_agg_kernel), which finds matches and slots with (capS x capR) and
// (capS x capS) equality matrices and reduces with one-hot matmuls on the
// TPU's matrix unit.
//
// What bounds it: bytes. Each probe row's join key, group key and values are
// read once, the build block once per sub-block, and one partial per live
// slot is written (the padded layout the group-join hands it writes every
// slot). The lookups and adds are far below the card's rates, as long as
// each row does a constant amount of work.
//
// Design: one thread per row of a sub-block (cap_s <= 1024), O(cap)
// shared-memory work per sub-block, and loads kept in flight:
//   - persistent blocks: a grid that fills the SMs walks the sub-blocks.
//     While a block works on one, cp.async copies the next one's probe
//     values, build keys and build values into the other half of a double
//     buffer (16-byte pieces where aligned), and each thread loads its next
//     probe key and group key into registers. A block per sub-block waited
//     for its loads before each phase, with about 1 KB in flight per block.
//   - match: the build keys go into an open-addressing table in shared memory
//     (at least 2 x cap_r slots, linear probing); a key held twice keeps its
//     lowest build slot by atomicMin, so the first match wins. Each row
//     probes it once.
//   - slot: a second table keyed by the whole masked group key (int32 or
//     int64) whose value is atomicMin of the row: the first row with the key.
//   - row order within a slot: each row sets its lane's bit in the word of
//     (its warp chunk of 32 rows, its slot), and its chunk's bit in its
//     slot's chunk word, by shared-memory atomicOr (bits commute);
//     __match_any_sync, which gives the same words, slows with the number
//     of distinct slots in a warp. From the two words each row finds the
//     next row of its slot, all rows at once.
//   - the thread of each slot follows that list from itself, which is row
//     order, and sums the rows' values (staged per row while matching): the
//     same float32 adds as the plain version, so the sums are bit-equal. (A
//     walk over the words themselves loops once per chunk as well as once
//     per row.) The tables and words are cleared while the slots sum, so a
//     sub-block costs five barriers.
// Only min, OR and CAS atomics in shared memory, whose results commute: the
// output does not depend on scheduling. A sub-block holding only padding
// writes empty slots and nothing else. Every store to the outputs is
// coalesced (thread s writes slot s).
#include <climits>

#include "common.cuh"

constexpr int MAX_ROWS = 1024;  // one thread per row
// sub-blocks of up to NARROW_ROWS rows run NARROW_BLOCKS_4 blocks an SM
// with int32 group keys, NARROW_BLOCKS_8 with int64 ones (fewer resident
// blocks left the SMs waiting); wider ones one. Eight blocks cap a thread
// at 32 registers: with int32 keys it spills 8 bytes, and six blocks (40
// registers, no spill) took 3.7% longer at J2; with int64 keys it spills 24
// bytes and took 13% longer than six (scripts/kernel_variants.py --kernel
// probe_agg; kernel_lint.py declares the int32 spill).
constexpr int NARROW_ROWS = 256, NARROW_BLOCKS_4 = 8, NARROW_BLOCKS_8 = 6;

// smallest b with 2^b >= 2 n: the tables stay at most half full
__host__ __device__ inline int table_bits(int n) {
  int b = 1;
  while ((1 << b) < 2 * n) ++b;
  return b;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// int32 words of one half of the double buffer: probe values (cp columns),
// build keys, build values (cb columns), each rounded up to 16 bytes
__host__ __device__ inline int buffer_words(int cap_r, int cap_s, int cb, int cp) {
  return round4(cp * cap_s) + round4(cap_r) + round4(cb * cap_r);
}

// int32 words before the double buffer: the group-key table first (8-byte
// keys stay aligned), the build-key table, the lowest row per group key, a
// lane word per (chunk, slot), a chunk word per slot, each row's value of
// each of the c columns and each row's successor, rounded up to 16 bytes
__host__ __device__ inline int table_words(int cap_r, int cap_s, int key_bytes, int c) {
  const int hb = 1 << table_bits(cap_r), hg = 1 << table_bits(cap_s);
  return round4(hg * key_bytes / 4 + 2 * hb + hg + (cap_s + 31) / 32 * cap_s + cap_s +
                c * cap_s + cap_s);
}

// bytes of dynamic shared memory; kernels/hash_probe.py reckons the same
__host__ __device__ inline size_t smem_bytes(int cap_r, int cap_s, int key_bytes, int cb,
                                             int cp, int c) {
  return 4 * static_cast<size_t>(table_words(cap_r, cap_s, key_bytes, c) +
                                 2 * buffer_words(cap_r, cap_s, cb, cp));
}

// start copying n int32 words from src to dst, in 16-byte pieces when both
// allow it
__device__ __forceinline__ void copy_words(int* dst, const void* src, int n) {
  const int* from = static_cast<const int*>(src);
  if (n % 4 == 0 && reinterpret_cast<size_t>(from) % 16 == 0) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async16(dst + i, from + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, from + i);
  }
}

__device__ __forceinline__ unsigned hash_to(long long x, int bits) {
  return static_cast<unsigned>((static_cast<unsigned long long>(x) * 0x9E3779B97F4A7C15ull) >>
                               (64 - bits));
}

__device__ __forceinline__ int cas(int* a, int cmp, int val) { return atomicCAS(a, cmp, val); }

__device__ __forceinline__ long long cas(long long* a, long long cmp, long long val) {
  return static_cast<long long>(atomicCAS(reinterpret_cast<unsigned long long*>(a),
                                          static_cast<unsigned long long>(cmp),
                                          static_cast<unsigned long long>(val)));
}

// the table position of key (never KEY_SENTINEL, which marks an empty
// position), claiming an empty one if the key is not there yet
template <typename K>
__device__ __forceinline__ unsigned insert(K* keys, int bits, K key) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned pos = hash_to(key, bits);
  for (;;) {
    const K prev = cas(&keys[pos], K(KEY_SENTINEL), key);
    if (prev == K(KEY_SENTINEL) || prev == key) return pos;
    pos = (pos + 1) & mask;
  }
}

// the views of one half of the double buffer
struct Staged {
  float* pv;     // (cp, cap_s)
  int* bkeys;    // (cap_r,)
  float* bvals;  // (cb, cap_r)
  __device__ Staged(int* base, int cap_r, int cap_s, int cp) {
    pv = reinterpret_cast<float*>(base);
    bkeys = base + round4(cp * cap_s);
    bvals = reinterpret_cast<float*>(bkeys + round4(cap_r));
  }
};

// start copying sub-block b's probe values and partition p's build block
// into st
__device__ __forceinline__ void stage(const Staged& st, const int* bkeys, const float* bvals,
                                      const float* pv, long long b, int p, bool part_ok,
                                      int cap_r, int cap_s, int cb, int cp) {
  copy_words(reinterpret_cast<int*>(st.pv), pv + b * cp * cap_s, cp * cap_s);
  if (part_ok) {
    const long long pb = static_cast<long long>(p) * cap_r;
    copy_words(st.bkeys, bkeys + pb, cap_r);
    copy_words(reinterpret_cast<int*>(st.bvals), bvals + pb * cb, cb * cap_r);
  }
  cp_async_commit();
}

template <typename K>
__device__ __forceinline__ void clear_tables(K* gkey, int* grep, int hg, int* bkey, int* bidx,
                                             int hb) {
  for (int i = threadIdx.x; i < hg; i += blockDim.x) {
    gkey[i] = K(KEY_SENTINEL);
    grep[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < hb; i += blockDim.x) {
    bkey[i] = KEY_SENTINEL;
    bidx[i] = INT_MAX;
  }
}

// MAX_THREADS rows at most; MIN_BLOCKS of them resident on an SM
template <typename K, int MAX_THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    probe_agg_kernel(const int* __restrict__ bkeys, const float* __restrict__ bvals,
                     const int* __restrict__ probe, const K* __restrict__ gk,
                     const float* __restrict__ pv, const int* __restrict__ block_part,
                     const int* __restrict__ col_src, long long num_blocks, int num_parts,
                     int cap_r, int cap_s, int cb, int cp, int c, K* __restrict__ pk,
                     float* __restrict__ ps, int* __restrict__ pc) {
  extern __shared__ long long smem[];
  const int hb_bits = table_bits(cap_r), hg_bits = table_bits(cap_s);
  const int hb = 1 << hb_bits, hg = 1 << hg_bits;
  const int chunks = blockDim.x >> 5;
  K* gkey = reinterpret_cast<K*>(smem);             // (hg,) group-key table
  int* bkey = reinterpret_cast<int*>(gkey + hg);    // (hb,) build-key table
  int* bidx = bkey + hb;                            // (hb,) lowest build slot per key
  int* grep = bidx + hb;                            // (hg,) lowest row per group key
  unsigned* lanes = reinterpret_cast<unsigned*>(grep + hg);  // (chunks, cap_s) lane words
  unsigned* chunk_words = lanes + chunks * cap_s;  // (cap_s,) chunk word per slot
  float* val = reinterpret_cast<float*>(chunk_words + cap_s);  // (c, cap_s) row values
  int* next = reinterpret_cast<int*>(val + c * cap_s);  // (cap_s,) next row of the slot
  int* buffers = reinterpret_cast<int*>(smem) +
                 table_words(cap_r, cap_s, static_cast<int>(sizeof(K)), c);
  const int half = buffer_words(cap_r, cap_s, cb, cp);

  const int s = threadIdx.x, lane = s & 31, chunk = s >> 5;
  const bool row = s < cap_s;
  const long long grid = gridDim.x;
  auto part_of = [&](long long i) { return i < num_blocks ? block_part[i] : -1; };
  auto valid = [&](int p) { return p >= 0 && p < num_parts; };
  auto key_of = [&](long long i) { return row && i < num_blocks ? probe[i * cap_s + s] : -1; };
  auto group_of = [&](long long i) {
    return row && i < num_blocks ? gk[i * cap_s + s] : K(KEY_SENTINEL);
  };
  clear_tables(gkey, grep, hg, bkey, bidx, hb);
  for (int i = s; i < chunks * cap_s; i += blockDim.x) lanes[i] = 0u;
  for (int i = s; i < cap_s; i += blockDim.x) chunk_words[i] = 0u;
  long long b = blockIdx.x;
  int p = part_of(b), p_next = part_of(b + grid);
  int key = key_of(b);
  K g = group_of(b);
  if (b < num_blocks)
    stage(Staged(buffers, cap_r, cap_s, cp), bkeys, bvals, pv, b, p, valid(p), cap_r, cap_s, cb,
          cp);

  for (int buf = 0; b < num_blocks; b += grid, buf ^= 1) {
    const Staged st(buffers + buf * half, cap_r, cap_s, cp);
    cp_async_wait_all();
    // every thread is past the last sub-block, and this one has landed
    const bool live = __syncthreads_or(key != KEY_SENTINEL && valid(p));
    const int p_after = part_of(b + 2 * grid);
    const int key_next = key_of(b + grid);
    const K g_next = group_of(b + grid);
    if (b + grid < num_blocks)
      stage(Staged(buffers + (buf ^ 1) * half, cap_r, cap_s, cp), bkeys, bvals, pv, b + grid,
            p_next, valid(p_next), cap_r, cap_s, cb, cp);
    const long long o = b * cap_s + s;
    if (live) {
      for (int j = s; j < cap_r; j += blockDim.x) {
        const int k = st.bkeys[j];
        if (k != KEY_SENTINEL) atomicMin(&bidx[insert(bkey, hb_bits, k)], j);
      }
      __syncthreads();

      // match; a matched row stages its values and puts its group key into
      // the group table
      int hit = -1;
      if (key != KEY_SENTINEL) {
        const unsigned mask = (1u << hb_bits) - 1u;
        for (unsigned pos = hash_to(key, hb_bits);; pos = (pos + 1) & mask) {
          const int k = bkey[pos];
          if (k == key) {
            hit = bidx[pos];
            break;
          }
          if (k == KEY_SENTINEL) break;
        }
      }
      const K gke = hit >= 0 ? g : K(KEY_SENTINEL);
      unsigned gpos = 0;
      if (gke != K(KEY_SENTINEL)) {
        for (int q = 0; q < c; ++q) {
          const int src = col_src[q];
          val[q * cap_s + s] =
              src >= 0 ? st.pv[src * cap_s + s] : st.bvals[(-src - 1) * cap_r + hit];
        }
        gpos = insert(gkey, hg_bits, gke);
        atomicMin(&grep[gpos], s);
      }
      __syncthreads();

      // the rows of each slot, by chunk and lane
      int slot = -1;
      if (gke != K(KEY_SENTINEL)) {
        slot = grep[gpos];
        atomicOr(&lanes[chunk * cap_s + slot], 1u << lane);
        atomicOr(&chunk_words[slot], 1u << chunk);
      }
      __syncthreads();

      // each row's successor in its slot
      if (slot >= 0) {
        const unsigned above = lanes[chunk * cap_s + slot] & ~((2u << lane) - 1u);
        int nxt = -1;
        if (above) {
          nxt = chunk * 32 + __ffs(above) - 1;
        } else {
          const unsigned later = chunk_words[slot] & ~((2u << chunk) - 1u);
          if (later) {
            const int w = __ffs(later) - 1;
            nxt = w * 32 + __ffs(lanes[w * cap_s + slot]) - 1;
          }
        }
        next[s] = nxt;
      }
      __syncthreads();

      // the tables and words are free again; the thread of each slot follows
      // its rows in row order, counting and summing
      clear_tables(gkey, grep, hg, bkey, bidx, hb);
      if (slot >= 0) {
        lanes[chunk * cap_s + slot] = 0u;
        chunk_words[slot] = 0u;
      }
      if (row) {
        const bool owner = slot == s;
        int total = 0;
        for (int q = 0; q < (c > 0 ? c : 1); ++q) {
          const float* v = val + q * cap_s;
          float acc = 0.f;
          int cnt = 0;
          if (owner) {
            for (int r = s; r >= 0; r = next[r]) {
              if (q < c) acc += v[r];
              ++cnt;
            }
          }
          if (q == 0) total = cnt;
          if (q < c) ps[(b * c + q) * cap_s + s] = acc;
        }
        pk[o] = total > 0 ? gke : K(KEY_SENTINEL);
        pc[o] = total;
      }
    } else if (row) {
      pk[o] = K(KEY_SENTINEL);
      pc[o] = 0;
      for (int q = 0; q < c; ++q) ps[(b * c + q) * cap_s + s] = 0.f;
    }
    p = p_next;
    p_next = p_after;
    key = key_next;
    g = g_next;
  }
}

static const KernelInstance INSTANCES[] = {
    {(const void*)probe_agg_kernel<int, NARROW_ROWS, NARROW_BLOCKS_4>, "probe_agg<4, 256, 8>"},
    {(const void*)probe_agg_kernel<int, MAX_ROWS, 1>, "probe_agg<4, 1024, 1>"},
    {(const void*)probe_agg_kernel<long long, NARROW_ROWS, NARROW_BLOCKS_8>,
     "probe_agg<8, 256, 6>"},
    {(const void*)probe_agg_kernel<long long, MAX_ROWS, 1>, "probe_agg<8, 1024, 1>"}};
EXPORT_INSTANCES(probe_agg)

// the grid of one instance: as many blocks as the occupancy calculator puts
// on the card at this call's shared memory (the limit raised past 48 KB
// when it needs more), and no more than the sub-blocks
template <typename K, int MAX_THREADS, int MIN_BLOCKS>
static cudaError_t grid_config(long long num_blocks, LaunchConfig* c) {
  auto kernel = probe_agg_kernel<K, MAX_THREADS, MIN_BLOCKS>;
  cudaError_t err = cudaSuccess;
  if (c->smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(c->smem));
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->per_sm, kernel, c->threads, c->smem);
  if (err != cudaSuccess) return err;
  if (c->per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fill = static_cast<long long>(c->sms) * c->per_sm;
  c->grid = num_blocks < fill ? num_blocks : fill;
  return cudaSuccess;
}

// The launch of one call: the instance of the group key's width and of the
// sub-block's rows, a thread a row (rounded up to whole warps), the tables,
// words and double buffer of smem_bytes in dynamic shared memory.
static cudaError_t config(long long num_blocks, int cap_r, int cap_s, int cb, int cp, int c_cols,
                          int key_bytes, LaunchConfig* c) {
  if (num_blocks < 1 || cap_s < 1 || cap_s > MAX_ROWS || cap_r < 1) return cudaErrorInvalidValue;
  const bool wide = key_bytes == 8;
  c->instance = 2 * wide + (cap_s > NARROW_ROWS);
  c->threads = ((cap_s + 31) / 32) * 32;
  c->smem = static_cast<long long>(
      smem_bytes(cap_r, cap_s, wide ? sizeof(long long) : sizeof(int), cb, cp, c_cols));
  switch (c->instance) {
    case 0: return grid_config<int, NARROW_ROWS, NARROW_BLOCKS_4>(num_blocks, c);
    case 1: return grid_config<int, MAX_ROWS, 1>(num_blocks, c);
    case 2: return grid_config<long long, NARROW_ROWS, NARROW_BLOCKS_8>(num_blocks, c);
    default: return grid_config<long long, MAX_ROWS, 1>(num_blocks, c);
  }
}

extern "C" int probe_agg_launch_config(long long num_blocks, int cap_r, int cap_s, int cb,
                                       int cp, int c_cols, int key_bytes, int device,
                                       long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(num_blocks, cap_r, cap_s, cb, cp, c_cols, key_bytes, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

template <typename K, int MAX_THREADS, int MIN_BLOCKS>
static void launch(const LaunchConfig& lc, const void* bkeys, const void* bvals,
                   const void* probe, const void* gk, const void* pv, const void* block_part,
                   const void* col_src, long long num_blocks, int num_parts, int cap_r,
                   int cap_s, int cb, int cp, int c, void* pk, void* ps, void* pc,
                   cudaStream_t stream) {
  probe_agg_kernel<K, MAX_THREADS, MIN_BLOCKS>
      <<<static_cast<unsigned>(lc.grid), lc.threads, lc.smem, stream>>>(
          static_cast<const int*>(bkeys), static_cast<const float*>(bvals),
          static_cast<const int*>(probe), static_cast<const K*>(gk),
          static_cast<const float*>(pv), static_cast<const int*>(block_part),
          static_cast<const int*>(col_src), num_blocks, num_parts, cap_r, cap_s, cb, cp, c,
          static_cast<K*>(pk), static_cast<float*>(ps), static_cast<int*>(pc));
}

// bkeys (num_parts, cap_r) int32, bvals (num_parts, cb, cap_r) float32,
// probe (num_blocks, cap_s) int32, gk (num_blocks, cap_s) int32 or int64
// (key_bytes 4 or 8), pv (num_blocks, cp, cap_s) float32, block_part
// (num_blocks,) int32, col_src (c,) int32 -> pk (num_blocks, cap_s) of gk's
// type, ps (num_blocks, c, cap_s) float32, pc (num_blocks, cap_s) int32.
extern "C" int probe_agg(const void* bkeys, const void* bvals, const void* probe, const void* gk,
                         const void* pv, const void* block_part, const void* col_src,
                         long long num_blocks, int num_parts, int cap_r, int cap_s, int cb,
                         int cp, int c, int key_bytes, void* pk, void* ps, void* pc,
                         void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig lc;
  const cudaError_t err = config(num_blocks, cap_r, cap_s, cb, cp, c, key_bytes, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lc.instance) {
    case 0:
      launch<int, NARROW_ROWS, NARROW_BLOCKS_4>(lc, bkeys, bvals, probe, gk, pv, block_part,
                                                col_src, num_blocks, num_parts, cap_r, cap_s, cb,
                                                cp, c, pk, ps, pc, st);
      break;
    case 1:
      launch<int, MAX_ROWS, 1>(lc, bkeys, bvals, probe, gk, pv, block_part, col_src, num_blocks,
                               num_parts, cap_r, cap_s, cb, cp, c, pk, ps, pc, st);
      break;
    case 2:
      launch<long long, NARROW_ROWS, NARROW_BLOCKS_8>(lc, bkeys, bvals, probe, gk, pv,
                                                      block_part, col_src, num_blocks, num_parts,
                                                      cap_r, cap_s, cb, cp, c, pk, ps, pc, st);
      break;
    default:
      launch<long long, MAX_ROWS, 1>(lc, bkeys, bvals, probe, gk, pv, block_part, col_src,
                                     num_blocks, num_parts, cap_r, cap_s, cb, cp, c, pk, ps, pc,
                                     st);
      break;
  }
  return launch_status();
}
