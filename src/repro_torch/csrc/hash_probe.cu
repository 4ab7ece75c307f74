// Co-partition probe of the partitioned hash join (PHJ match finding).
// For each key of a probe sub-block b, the first slot of its co-partition's
// build block (block_part[b]) that holds an equal key:
//   vid = off_r[part] + slot, hit = 1   or   vid = -1, hit = 0.
// KEY_SENTINEL probe keys never match.
//
// Replaces: src/repro/kernels/hash_probe.py, hash_probe_pallas
// (_probe_kernel), which compares a (capS x capR) equality matrix on the
// TPU's vector unit and takes an iota-min over it.
//
// What bounds it: bytes. Each probe key is read once and two int32 results
// written; the build block (capR keys) is read once per sub-block. The
// compares are a few dozen per key at the join's fan-out, far below the
// card's integer rate.
//
// Design: one thread block per probe sub-block. The build block is staged in
// shared memory once, then each thread walks it for its key and stops at the
// first match; all threads of a warp read the same shared word at each step
// (a broadcast, no bank conflict).
#include "common.cuh"

__global__ void hash_probe_kernel(const int* __restrict__ bkeys, const int* __restrict__ off_r,
                                  const int* __restrict__ probe,
                                  const int* __restrict__ block_part, int num_parts,
                                  int cap_r, int cap_s, int* __restrict__ vid,
                                  int* __restrict__ hit) {
  extern __shared__ int block[];  // (cap_r,) build keys of this sub-block's partition
  const long long b = blockIdx.x;
  const int p = block_part[b];
  const bool part_ok = p >= 0 && p < num_parts;
  for (int j = threadIdx.x; j < cap_r; j += blockDim.x)
    block[j] = part_ok ? bkeys[static_cast<long long>(p) * cap_r + j] : KEY_SENTINEL;
  __syncthreads();
  const int base = part_ok ? off_r[p] : 0;
  for (int s = threadIdx.x; s < cap_s; s += blockDim.x) {
    const long long o = b * cap_s + s;
    const int key = probe[o];
    int pos = -1;
    if (key != KEY_SENTINEL) {
      for (int j = 0; j < cap_r; ++j) {
        if (block[j] == key) {
          pos = j;
          break;
        }
      }
    }
    vid[o] = pos >= 0 ? base + pos : -1;
    hit[o] = pos >= 0 ? 1 : 0;
  }
}

// bkeys (num_parts, cap_r), off_r (num_parts,), probe (num_blocks, cap_s),
// block_part (num_blocks,) -> vid, hit (num_blocks, cap_s); all int32.
extern "C" int hash_probe(const void* bkeys, const void* off_r, const void* probe,
                          const void* block_part, long long num_blocks, int num_parts,
                          int cap_r, int cap_s, void* vid, void* hit, void* stream) {
  const int threads = cap_s < 256 ? ((cap_s + 31) / 32) * 32 : 256;
  hash_probe_kernel<<<static_cast<unsigned>(num_blocks), threads, cap_r * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bkeys), static_cast<const int*>(off_r),
      static_cast<const int*>(probe), static_cast<const int*>(block_part), num_parts, cap_r,
      cap_s, static_cast<int*>(vid), static_cast<int*>(hit));
  return launch_status();
}
