// Per-tile partial sums over key-sorted rows (the sort-based group-by).
// For tile t of `tile` rows (the last one padded with KEY_SENTINEL keys), the
// runs of equal valid keys are numbered 0, 1, ... in row order, and run g
// writes slot t * tile + g: its key, the float32 sum of its values and its
// row count. Slots past the tile's last run get KEY_SENTINEL and zeros. A run
// that spans tiles gives one partial in each; the combine merges them.
//
// Replaces: src/repro/kernels/segsum.py, segsum_partials_pallas
// (_segsum_kernel), which reduces each tile with one-hot matmuls on the TPU's
// matrix unit and moves keys through it as 16-bit halves.
//
// What bounds it: bytes. Each key and value is read once and three slots
// are written per row; the scan and the adds are a few operations per row.
//
// Design: one thread block per tile, one thread per row. A row is a run head
// when its key is valid and differs from the row before it. The local run id
// of a head is the number of heads before it, from a warp ballot and a scan
// of the per-warp counts: no atomics. The head then sums its run in row
// order, so the float32 sums do not depend on scheduling.
#include "common.cuh"

template <typename K>
__global__ void segsum_partials_kernel(const K* __restrict__ keys, const float* __restrict__ vals,
                                       long long n, int tile, K* __restrict__ pk,
                                       float* __restrict__ ps, int* __restrict__ pc) {
  extern __shared__ long long smem[];
  K* k = reinterpret_cast<K*>(smem);                 // (tile,) keys of this tile
  float* v = reinterpret_cast<float*>(k + tile);     // (tile,) values
  int* warp_heads = reinterpret_cast<int*>(v + tile);  // (32,) run heads per warp

  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const int i = threadIdx.x;
  K key = K(KEY_SENTINEL);
  if (i < tile) {
    const long long r = base + i;
    key = r < n ? keys[r] : K(KEY_SENTINEL);
    k[i] = key;
    v[i] = r < n ? vals[r] : 0.f;
  }
  __syncthreads();
  const bool head = i < tile && key != K(KEY_SENTINEL) && (i == 0 || k[i - 1] != key);

  const int lane = i & 31, warp = i >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, head);
  if (lane == 0) warp_heads[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u)), runs = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    before += w < warp ? warp_heads[w] : 0;
    runs += warp_heads[w];
  }

  if (i < tile && i >= runs) {
    pk[base + i] = K(KEY_SENTINEL);
    ps[base + i] = 0.f;
    pc[base + i] = 0;
  }
  if (head) {
    float acc = 0.f;
    int cnt = 0;
    for (int j = i; j < tile && k[j] == key; ++j) {
      acc += v[j];
      ++cnt;
    }
    pk[base + before] = key;
    ps[base + before] = acc;
    pc[base + before] = cnt;
  }
}

template <typename K>
static int launch(const void* keys, const void* vals, long long n, int tile, void* pk, void* ps,
                  void* pc, cudaStream_t stream) {
  const long long num_tiles = (n + tile - 1) / tile;
  const int threads = ((tile + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(tile) * (sizeof(K) + sizeof(float)) + 32 * sizeof(int);
  segsum_partials_kernel<K><<<static_cast<unsigned>(num_tiles), threads, smem, stream>>>(
      static_cast<const K*>(keys), static_cast<const float*>(vals), n, tile, static_cast<K*>(pk),
      static_cast<float*>(ps), static_cast<int*>(pc));
  return launch_status();
}

// keys (n,) int32 or int64 (key_bytes 4 or 8), sorted; vals (n,) float32;
// tile <= 1024 -> pk, ps, pc of ceil(n / tile) * tile slots: keys of the keys'
// type, float32 sums, int32 counts.
extern "C" int segsum_partials(const void* keys, const void* vals, long long n, int tile,
                               int key_bytes, void* pk, void* ps, void* pc, void* stream,
                               int device) {
  DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8) return launch<long long>(keys, vals, n, tile, pk, ps, pc, st);
  return launch<int>(keys, vals, n, tile, pk, ps, pc, st);
}
