// Per-tile partial sums over key-sorted rows (the sort-based group-by),
// written compactly. For tile t of `tile` rows, each run of equal valid keys
// (not KEY_SENTINEL) gives one partial: its key, the float32 sum of its
// values in row order and its row count. The partials are written without
// gaps, tile t's after those of every earlier tile and in row order within
// it; a run that spans tiles gives one partial in each, and the combine
// merges them (they are neighbours, since the rows are sorted). The last
// chunk writes the number of partials to state[1], or -1 when any key is
// smaller than the key before it.
//
// Replaces: src/repro/kernels/segsum.py, segsum_partials_pallas
// (_segsum_kernel), which reduces each tile with one-hot matmuls on the TPU's
// matrix unit, moves keys through it as 16-bit halves, and writes one slot
// per row (KEY_SENTINEL and zeros past a tile's last run).
//
// What bounds it: bytes. Each key and value is read once and one partial
// (12 or 16 bytes) is written per run; the scan and the adds are a few
// operations per row.
//
// Design: persistent blocks take chunks of whole tiles (at most CHUNK rows)
// by an atomic ticket, in order, each claimed an iteration ahead so that the
// ticket's round trip is hidden. A block works on several chunks at once:
// the next one's rows fly into shared memory (cp.async, into a second
// buffer) while the current one is summed, and the partials of the chunk
// STAGES before leave once its output offset is known. It has ROW_WARPS
// warps of row threads (ITEMS consecutive rows each) and one look-back warp:
//  - The row threads mark the run edges of their rows in a bitmap (a tile
//    start, or a key unlike the row before), check that no key is below the
//    one before it, count the run heads (edges with a valid key) in a block
//    scan, and publish the chunk's count to a decoupled look-back at once.
//    Then they sum every run in row order, all in step: each folds its rows
//    (from 0.f at each edge) and stages the key, sum and count of each run
//    that ends in its rows; a run that goes on across lanes passes its fold
//    and row count from lane to lane, one round a lane. So every sum is bit
//    for bit the plain version's (a run's rows added one by one from 0.f),
//    and no lane waits on another's run length. On the default 256-row tiles
//    a warp's rows are whole tiles; a run that leaves its warp's rows (wider
//    or unaligned tiles) is summed by its head thread alone. Sixteen rows a
//    thread halve the rounds of a run as long as a tile.
//  - The look-back warp finds each chunk's output offset on its own: it adds
//    up the counts of the chunks before it, LOOKBACK * 32 a round trip, back
//    to the nearest one that has its inclusive prefix, and publishes that of
//    its own chunk. It has STAGES chunks' time before the row threads need
//    the offset, so they seldom wait for it.
// The offsets are integer prefix sums, so they do not depend on which chunk
// finishes first; no float passes between chunks. The staged partials leave
// with coalesced stores. scripts/kernel_variants.py times the choices.
#include "common.cuh"

constexpr int ROW_WARPS = 2;
constexpr int ITEMS = 16;  // consecutive rows a row thread
constexpr int ROW_THREADS = ROW_WARPS * 32;
constexpr int THREADS = ROW_THREADS + 32;  // and the look-back warp
constexpr int BLOCKS_PER_SM = 5;           // registers for the blocks the shared memory allows
constexpr int LOOKBACK = 1;                // look-back words a lane reads at once
// chunks whose partials wait, staged, for their output offset: the
// look-back warp has this many chunks' time to find one
constexpr int STAGES = 2;
// look-back words sit a 128-byte line apart, so that the warps polling the
// newest chunks do not all wait on one line of the L2
constexpr int STATUS_STRIDE = 16;
constexpr int CHUNK = ROW_THREADS * ITEMS;
constexpr int WORD_THREADS = 32 / ITEMS;  // threads whose rows make a 32-bit word
static_assert(32 % ITEMS == 0, "a thread's rows must not straddle a word of the edge bitmap");
constexpr unsigned FULL = 0xffffffffu;

// A chunk's look-back word: the state in bits 62-63 (0: nothing yet, 1: the
// chunk's own count, 2: the inclusive prefix through it), the unsorted flag in
// bit 61 and the count of partials in bits 0-60.
constexpr unsigned long long AGGREGATE = 1ull << 62, PREFIX = 2ull << 62, STATE = 3ull << 62;
constexpr unsigned long long UNSORTED = 1ull << 61, COUNT = UNSORTED - 1;

// Shared-memory index of element i of a padded array: one spare element
// every 128 bytes, so that 32 threads reading ITEMS consecutive elements each
// fall in distinct banks.
template <typename T>
__device__ __forceinline__ int sp(int i) {
  return i + i / (128 / static_cast<int>(sizeof(T)));
}

template <typename T>
__host__ __device__ constexpr int padded_len() {
  return CHUNK + CHUNK / (128 / static_cast<int>(sizeof(T)));
}

// two buffers of rows (keys, values), and STAGES slots of staged partials
// (keys, sums, counts)
template <typename K>
constexpr size_t smem_bytes() {
  return (2 + STAGES) * padded_len<K>() * sizeof(K) +
         (2 + 2 * STAGES) * padded_len<float>() * sizeof(float);
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// cp.async of one 8-byte key (common.cuh has the 4- and 16-byte copies)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

template <typename K>
__device__ __forceinline__ void cp_async_key(K* dst, const K* src) {
  if (sizeof(K) == 8)
    cp_async8(dst, src);
  else
    cp_async4(dst, src);
}

__device__ __forceinline__ int chunk_rows_of(long long c, int chunk_rows, long long n) {
  return static_cast<int>(min(static_cast<long long>(chunk_rows), n - c * chunk_rows));
}

// Start copying chunk c's rows, and the key before them, into a buffer (one
// commit group of the calling row thread): each warp instruction moves 32
// neighbouring rows.
template <typename K>
__device__ __forceinline__ void fetch(const K* __restrict__ keys, const float* __restrict__ vals,
                                      long long c, int chunk_rows, long long n, K* sk, float* sv,
                                      K* before) {
  const long long start = c * chunk_rows;
  const int rows = chunk_rows_of(c, chunk_rows, n);
  for (int i = threadIdx.x; i < rows; i += ROW_THREADS) {
    cp_async_key(&sk[sp<K>(i)], keys + start + i);
    cp_async4(&sv[sp<float>(i)], vals + start + i);
  }
  if (threadIdx.x == 0 && start > 0) cp_async_key(before, keys + start - 1);
  cp_async_commit();
}

// The partials of every chunk before chunk c, and whether any of them found
// keys out of order, from the look-back words: the chunk d + 1 before c is
// word d / 32 of lane d % 32. A warp adds up the counts of the chunks back
// to the nearest one that has its inclusive prefix, LOOKBACK * 32 a round
// trip, waiting for those that have published nothing yet.
__device__ __forceinline__ unsigned long long look_back(const unsigned long long* status,
                                                       long long c, bool& unsorted) {
  const int lane = threadIdx.x % 32;
  unsigned long long before = 0;
  unsorted = false;
  for (long long p = c - 1; p >= 0; p -= 32 * LOOKBACK) {
    unsigned long long w[LOOKBACK];
#pragma unroll
    for (int i = 0; i < LOOKBACK; ++i) {
      const long long q = p - i * 32 - lane;
      w[i] = q >= 0 ? load_word(status + q * STATUS_STRIDE) : PREFIX;  // before chunk 0: 0
    }
    int limit;  // the nearest chunk with its prefix, or the window's last
    bool found;
    for (;;) {
      limit = 32 * LOOKBACK - 1;
      found = false;
#pragma unroll
      for (int i = LOOKBACK - 1; i >= 0; --i) {
        const unsigned pre = __ballot_sync(FULL, (w[i] & STATE) == PREFIX);
        if (pre) {
          limit = i * 32 + __ffs(pre) - 1;
          found = true;
        }
      }
      bool waiting = false;
#pragma unroll
      for (int i = 0; i < LOOKBACK; ++i) waiting |= i * 32 + lane <= limit && (w[i] & STATE) == 0;
      if (!__any_sync(FULL, waiting)) break;
#pragma unroll
      for (int i = 0; i < LOOKBACK; ++i)
        if (i * 32 + lane <= limit && (w[i] & STATE) == 0)
          w[i] = load_word(status + (p - i * 32 - lane) * STATUS_STRIDE);
    }
    unsigned long long x = 0;
    bool flagged = false;
#pragma unroll
    for (int i = 0; i < LOOKBACK; ++i) {
      if (i * 32 + lane <= limit) {
        x += w[i] & COUNT;
        flagged |= (w[i] & UNSORTED) != 0;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) x += __shfl_xor_sync(FULL, x, d);
    before += x;
    unsorted |= __any_sync(FULL, flagged);
    if (found) break;
  }
  return before;
}

__device__ __forceinline__ void row_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(ROW_THREADS) : "memory");
}

__device__ __forceinline__ int load_flag(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_flag(int* p, int v) {
  __threadfence_block();  // what the flag announces is in shared memory first
  *reinterpret_cast<volatile int*>(p) = v;
}

// state (state_words): [0] the chunk ticket, [1] the partial count (written
// by the last chunk), [(1 + c) * STATUS_STRIDE] chunk c's look-back word; all
// 0 at launch.
template <typename K>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) segsum_partials_kernel(
    const K* __restrict__ keys, const float* __restrict__ vals, long long n, int tile,
    int chunk_rows, long long num_chunks, K* __restrict__ pk, float* __restrict__ ps,
    int* __restrict__ pc, unsigned long long* __restrict__ state) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* const kbuf = reinterpret_cast<K*>(smem);  // two buffers of keys
  K* const stk = kbuf + 2 * padded_len<K>();   // STAGES slots of staged partial keys
  float* const vbuf = reinterpret_cast<float*>(stk + STAGES * padded_len<K>());  // values
  float* const sts = vbuf + 2 * padded_len<float>();  // staged sums
  int* const stc = reinterpret_cast<int*>(sts + STAGES * padded_len<float>());  // counts
  __shared__ K s_before[2];  // the key before each buffer's chunk
  __shared__ long long s_first, s_next;
  // each slot's chunk (-1: none), its partials, its unsorted flag, and the
  // output offset the look-back warp found for it
  __shared__ long long s_slot_chunk[STAGES], s_slot_offset[STAGES];
  __shared__ int s_slot_count[STAGES], s_slot_unsorted[STAGES];
  // slots handed to the look-back warp, slots it has answered, and whether
  // the row threads are done
  __shared__ int s_handed, s_answered, s_closed;
  __shared__ int s_warp_heads[ROW_WARPS], s_warp_unsorted[ROW_WARPS];
  // the chunk's run edges, a bit a row, and a word of edges past its end
  __shared__ unsigned s_edges[CHUNK / 32 + 1];
  unsigned long long* status = state + STATUS_STRIDE;  // chunk c's word: status[c * STATUS_STRIDE]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t == 0) {
    s_edges[CHUNK / 32] = ~0u;
    s_first = static_cast<long long>(atomicAdd(state, 1ull));
    s_handed = s_answered = s_closed = 0;
  }
  __syncthreads();

  if (warp == ROW_WARPS) {
    // the look-back warp: each handed slot's offset, in order
    for (int j = 0;; ++j) {
      while (load_flag(&s_handed) <= j)
        if (load_flag(&s_closed) && load_flag(&s_handed) <= j) return;
      const int slot = j % STAGES;
      const long long c = s_slot_chunk[slot];
      if (c >= 0) {
        bool unsorted;
        const unsigned long long before = look_back(status, c, unsorted);
        if (lane == 0) {
          const unsigned long long total = before + s_slot_count[slot];
          unsorted |= s_slot_unsorted[slot] != 0;
          if (c > 0)
            store_word(status + c * STATUS_STRIDE, PREFIX | total | (unsorted ? UNSORTED : 0ull));
          if (c == num_chunks - 1) state[1] = unsorted ? ~0ull : total;  // ~0: -1 as int64
          s_slot_offset[slot] = static_cast<long long>(before);
        }
      }
      __syncwarp();
      if (lane == 0) store_flag(&s_answered, j + 1);
    }
  }

  // the row threads; thread 0 claims each chunk an iteration before its rows
  // are fetched, so that the ticket's round trip is hidden
  const int r0 = t * ITEMS;
  long long cur = s_first;
  unsigned long long claimed = t == 0 ? atomicAdd(state, 1ull) : 0;
  if (cur < num_chunks) fetch<K>(keys, vals, cur, chunk_rows, n, kbuf, vbuf, &s_before[0]);
  for (int i = 0, tail = STAGES;; ++i) {
    const int slot = i % STAGES, b = i % 2;
    const bool live = cur < num_chunks;
    if (!live && tail-- == 0) break;  // and the last chunks' partials have left
    if (t == 0) {
      s_next = static_cast<long long>(claimed);
      while (load_flag(&s_answered) <= i - STAGES) {  // the slot's offset is in
      }
    }
    cp_async_wait_all();
    row_barrier();  // cur's rows are in, s_next is set, the slot's offset is in
    const long long next = s_next;
    if (t == 0) claimed = atomicAdd(state, 1ull);  // the chunk after next
    K* const sk = kbuf + b * padded_len<K>();
    const float* const sv = vbuf + b * padded_len<float>();
    const long long start = cur * chunk_rows;
    const int rows = live ? chunk_rows_of(cur, chunk_rows, n) : 0;
    if (next < num_chunks)
      fetch<K>(keys, vals, next, chunk_rows, n, kbuf + (b ^ 1) * padded_len<K>(),
               vbuf + (b ^ 1) * padded_len<float>(), &s_before[b ^ 1]);
    if (i >= STAGES && s_slot_chunk[slot] >= 0) {  // the slot's partials leave
      const long long out = s_slot_offset[slot];
      const int count = s_slot_count[slot];
      const K* const k_ = stk + slot * padded_len<K>();
      const float* const s_ = sts + slot * padded_len<float>();
      const int* const c_ = stc + slot * padded_len<float>();
      for (int r = t; r < count; r += ROW_THREADS) {
        pk[out + r] = k_[sp<K>(r)];
        ps[out + r] = s_[sp<float>(r)];
        pc[out + r] = c_[sp<float>(r)];
      }
    }

    // run heads and run edges of this thread's rows, and the order check. A
    // row is an edge when it starts a tile or its key differs from the row
    // before; a head is an edge with a valid key. Rows past the chunk's last
    // are edges, so every run ends at an edge.
    K k[ITEMS];
    unsigned heads = 0, edges = 0;
    bool unsorted = false;
    int m = r0 % tile;  // row r0's place in its tile
    K prev = r0 == 0 ? s_before[b] : (r0 < rows ? sk[sp<K>(r0 - 1)] : K(0));
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = r0 + j;
      k[j] = r < rows ? sk[sp<K>(r)] : K(KEY_SENTINEL);
      if (r < rows) {
        if (r > 0 || start > 0) unsorted |= k[j] < prev;
        if (m == 0 || k[j] != prev) {
          edges |= 1u << j;
          if (k[j] != K(KEY_SENTINEL)) heads |= 1u << j;
        }
      } else {
        edges |= 1u << j;
      }
      prev = k[j];
      if (++m == tile) m = 0;
    }
    // the edges as a bitmap of the chunk's rows: the threads of a word OR
    // their bits together
    unsigned word = edges << (lane % WORD_THREADS * ITEMS);
#pragma unroll
    for (int d = 1; d < WORD_THREADS; d *= 2) word |= __shfl_xor_sync(FULL, word, d);
    if (lane % WORD_THREADS == 0) s_edges[t / WORD_THREADS] = word;
    // block scan of the head counts
    const int own = __popc(heads);
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int x = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += x;
    }
    const bool warp_unsorted = __any_sync(FULL, unsorted);
    if (lane == 31) {
      s_warp_heads[warp] = incl;
      s_warp_unsorted[warp] = warp_unsorted;
    }
    row_barrier();  // the head counts and the edges are in; the slot has left
    int offset = incl - own, count = 0;
    bool chunk_unsorted = false;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) {
      offset += w < warp ? s_warp_heads[w] : 0;
      count += s_warp_heads[w];
      chunk_unsorted |= s_warp_unsorted[w] != 0;
    }
    if (t == 0) {
      // publish this chunk's count at once, and hand the slot to the
      // look-back warp
      if (live)
        store_word(status + cur * STATUS_STRIDE,
                   (cur == 0 ? PREFIX : AGGREGATE) | static_cast<unsigned long long>(count) |
                       (chunk_unsorted ? UNSORTED : 0ull));
      s_slot_chunk[slot] = live ? cur : -1;
      s_slot_count[slot] = count;
      s_slot_unsorted[slot] = chunk_unsorted;
      store_flag(&s_handed, i + 1);
    }

    if (live) {
      // Each run's partial, its sum in row order. A run that starts in a
      // thread's rows and ends there is summed and staged by it; a piece that
      // goes on with a run from the lanes before waits for their carry (sum
      // and count so far), one round a lane, and the thread that ends the run
      // stages it. A run that leaves its warp's rows (where tiles do not
      // align with them) is summed by its head thread alone, out of shared
      // memory.
      K* const k_ = stk + slot * padded_len<K>();
      float* const s_ = sts + slot * padded_len<float>();
      int* const c_ = stc + slot * padded_len<float>();
      float v[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) v[j] = sv[sp<float>(r0 + j)];
      const int after = r0 + ITEMS;  // the row after this thread's; an edge past the chunk
      const unsigned next_edge = s_edges[after / 32] >> (after % 32) & 1u;
      const unsigned ends = (edges | next_edge << ITEMS) >> 1;  // bit j: row j ends its run
      const int first = edges ? __ffs(edges) - 1 : ITEMS;  // rows going on with a run from before
      float acc = 0.f;
      int h = 0;  // the row of this thread's last edge so far
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (edges >> j & 1u) {
          acc = 0.f;
          h = j;
        }
        acc += v[j];
        if (j >= first && (ends >> j & 1u) && k[j] != K(KEY_SENTINEL)) {
          const int g = offset + __popc(heads & ((2u << j) - 1u)) - 1;
          k_[sp<K>(g)] = k[j];
          s_[sp<float>(g)] = acc;
          c_[sp<float>(g)] = j - h + 1;
        }
      }
      // carries along the warp: the fold and the row count of the last run
      // piece of each lane
      bool known = edges != 0 || lane == 0;
      float carry = acc;
      int carried = ITEMS - h;
      while (!__all_sync(FULL, known)) {
        const float up = __shfl_up_sync(FULL, carry, 1);
        const int up_rows = __shfl_up_sync(FULL, carried, 1);
        const bool up_known = __shfl_up_sync(FULL, known, 1);
        if (!known && up_known) {
#pragma unroll
          for (int j = 0; j < ITEMS; ++j) carry = (j == 0 ? up : carry) + v[j];
          carried = up_rows + ITEMS;
          known = true;
        }
      }
      const float carry_in = __shfl_up_sync(FULL, carry, 1);
      const int carried_in = __shfl_up_sync(FULL, carried, 1);
      const unsigned with_edge = __ballot_sync(FULL, edges != 0);
      const bool head_in_warp = (with_edge & ((1u << lane) - 1u)) != 0;
      if (first > 0 && (first < ITEMS || next_edge) && head_in_warp &&
          k[0] != K(KEY_SENTINEL)) {
        float c = carry_in;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
          if (j < first) c += v[j];
        k_[sp<K>(offset - 1)] = k[0];
        s_[sp<float>(offset - 1)] = c;
        c_[sp<float>(offset - 1)] = carried_in + first;
      }
      // the warp's last run, when it goes on past the warp's rows
      const int warp_end = (warp + 1) * 32 * ITEMS;
      if (with_edge && !(s_edges[warp_end / 32] >> (warp_end % 32) & 1u) &&
          lane == 31 - __clz(with_edge) && (heads >> h & 1u)) {
        const int r = r0 + h;
        int wi = (r + 1) / 32;
        unsigned e = s_edges[wi] & (~0u << ((r + 1) % 32));
        while (e == 0) e = s_edges[++wi];
        const int end = wi * 32 + __ffs(e) - 1;
        float walk = 0.f;
        for (int i = r; i < end; ++i) walk += sv[sp<float>(i)];
        const int g = offset + __popc(heads & ((1u << h) - 1u));
        k_[sp<K>(g)] = sk[sp<K>(r)];
        s_[sp<float>(g)] = walk;
        c_[sp<float>(g)] = end - r;
      }
    }
    cur = next;
  }
  if (t == 0) store_flag(&s_closed, 1);
}

static long long state_words(long long n, int chunk_rows) {
  return ((n + chunk_rows - 1) / chunk_rows + 1) * STATUS_STRIDE;
}

static const KernelInstance INSTANCES[] = {
    {(const void*)segsum_partials_kernel<int>, "segsum_partials<4>"},
    {(const void*)segsum_partials_kernel<long long>, "segsum_partials<8>"}};
EXPORT_INSTANCES(segsum_partials)

// the grid of one instance: as many blocks as fill the card, and no more
// than the chunks
template <typename K>
static cudaError_t grid_config(long long num_chunks, LaunchConfig* c) {
  c->smem = static_cast<long long>(smem_bytes<K>());
  static Fill cache[MAX_DEVICES] = {};
  Fill fill;
  const cudaError_t err =
      grid_fill(segsum_partials_kernel<K>, THREADS, smem_bytes<K>(), cache, &fill);
  if (err != cudaSuccess) return err;
  c->sms = fill.sms;
  c->per_sm = fill.per_sm;
  const long long cap = static_cast<long long>(fill.sms) * fill.per_sm;
  c->grid = num_chunks < cap ? num_chunks : cap;
  return cudaSuccess;
}

// The launch of one call: the instance of the key's width; ROW_WARPS warps
// of row threads and the look-back warp a block; two buffers of rows and
// STAGES slots of staged partials in dynamic shared memory.
static cudaError_t config(long long n, int tile, int key_bytes, LaunchConfig* c) {
  if (tile < 1 || tile > 1024 || n < 1) return cudaErrorInvalidValue;
  const int chunk_rows = CHUNK / tile * tile;
  const long long num_chunks = (n + chunk_rows - 1) / chunk_rows;
  c->instance = key_bytes == 8;
  c->threads = THREADS;
  return c->instance ? grid_config<long long>(num_chunks, c) : grid_config<int>(num_chunks, c);
}

extern "C" int segsum_partials_launch_config(long long n, int tile, int key_bytes, int device,
                                             long long* out) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  const cudaError_t err = config(n, tile, key_bytes, &c);
  put_config(c, out);
  return static_cast<int>(err);
}

// The int64 words of scratch `segsum_partials` needs for n rows in tiles of
// `tile` rows (0 for a tile it does not take).
extern "C" long long segsum_partials_state_words(long long n, int tile) {
  const int chunk_rows = CHUNK / tile * tile;
  return tile < 1 || tile > 1024 || chunk_rows == 0 ? 0 : state_words(n, chunk_rows);
}

// keys (n,) int32 or int64 (key_bytes 4 or 8), n >= 1; vals (n,) float32;
// 1 <= tile <= 1024 -> pk, ps, pc of room for n partials (keys of the keys'
// type, float32 sums, int32 counts), filled from the front; state of
// segsum_partials_state_words(n, tile) int64 words, scratch whose word 1 gets
// the number of partials, or -1 when the keys are not sorted.
extern "C" int segsum_partials(const void* keys, const void* vals, long long n, int tile,
                               int key_bytes, void* pk, void* ps, void* pc, void* state,
                               void* stream, int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  LaunchConfig c;
  cudaError_t err = config(n, tile, key_bytes, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk_rows = CHUNK / tile * tile;
  const long long num_chunks = (n + chunk_rows - 1) / chunk_rows;
  err = cudaMemsetAsync(state, 0, state_words(n, chunk_rows) * sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.instance) {
    segsum_partials_kernel<long long><<<static_cast<unsigned>(c.grid), c.threads, c.smem, st>>>(
        static_cast<const long long*>(keys), static_cast<const float*>(vals), n, tile,
        chunk_rows, num_chunks, static_cast<long long*>(pk), static_cast<float*>(ps),
        static_cast<int*>(pc), static_cast<unsigned long long*>(state));
  } else {
    segsum_partials_kernel<int><<<static_cast<unsigned>(c.grid), c.threads, c.smem, st>>>(
        static_cast<const int*>(keys), static_cast<const float*>(vals), n, tile, chunk_rows,
        num_chunks, static_cast<int*>(pk), static_cast<float*>(ps), static_cast<int*>(pc),
        static_cast<unsigned long long*>(state));
  }
  return launch_status();
}
