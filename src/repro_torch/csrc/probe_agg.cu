// Fused probe + tile-local grouped aggregation of the group-join.
// For one probe sub-block b of cap_s rows, against its co-partition's build
// block (block_part[b]):
//   1. each row's first matching build slot (as hash_probe.cu);
//   2. its group key, masked to KEY_SENTINEL when the row did not match;
//   3. its slot: the lowest row of the sub-block with the same masked key;
//   4. per slot, the key, one float32 sum per aggregate column and an int32
//      count of the rows it owns; a slot that owns no row gets KEY_SENTINEL
//      and zeros.
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
// slot is written (the padded layout writes every slot). The compares (the
// probe up to the first hit, the slot scan up to the first equal key) and
// the adds are far below the card's integer and float rates.
//
// Design: one thread block per sub-block. The build keys and values are
// staged in shared memory, then the masked group keys and each row's
// resolved values. The slot of a row is found by scanning the rows before it
// (all threads of a warp read the same word: a broadcast). The owner of a
// slot then sums its rows in row order, so the float32 sums do not depend on
// scheduling: no atomics anywhere. A sub-block holding only padding writes
// empty slots and stops before staging anything.
#include "common.cuh"

template <typename K>
__global__ void probe_agg_kernel(const int* __restrict__ bkeys, const float* __restrict__ bvals,
                                 const int* __restrict__ probe, const K* __restrict__ gk,
                                 const float* __restrict__ pv,
                                 const int* __restrict__ block_part,
                                 const int* __restrict__ col_src, int num_parts, int cap_r,
                                 int cap_s, int cb, int cp, int c, K* __restrict__ pk,
                                 float* __restrict__ ps, int* __restrict__ pc) {
  extern __shared__ long long smem[];
  K* gke = reinterpret_cast<K*>(smem);                     // (cap_s,) masked group keys
  int* rep = reinterpret_cast<int*>(gke + cap_s);          // (cap_s,) slot of each row
  int* bkey = rep + cap_s;                                 // (cap_r,) build keys
  float* bval = reinterpret_cast<float*>(bkey + cap_r);    // (cb, cap_r) build values
  float* val = bval + static_cast<long long>(cb) * cap_r;  // (c, cap_s) row values

  const long long b = blockIdx.x;
  const int p = block_part[b];
  const bool part_ok = p >= 0 && p < num_parts;
  int any = 0;
  for (int s = threadIdx.x; s < cap_s; s += blockDim.x)
    any |= probe[b * cap_s + s] != KEY_SENTINEL;
  if (!__syncthreads_or(any && part_ok)) {
    for (int s = threadIdx.x; s < cap_s; s += blockDim.x) {
      pk[b * cap_s + s] = K(KEY_SENTINEL);
      pc[b * cap_s + s] = 0;
      for (int q = 0; q < c; ++q) ps[(b * c + q) * cap_s + s] = 0.f;
    }
    return;
  }

  const long long pb = static_cast<long long>(p) * cap_r;
  for (int j = threadIdx.x; j < cap_r; j += blockDim.x) bkey[j] = bkeys[pb + j];
  for (int i = threadIdx.x; i < cb * cap_r; i += blockDim.x) bval[i] = bvals[pb * cb + i];
  __syncthreads();

  // match, masked group key, and the values each row adds
  for (int s = threadIdx.x; s < cap_s; s += blockDim.x) {
    const long long o = b * cap_s + s;
    const int key = probe[o];
    int hit = -1;
    if (key != KEY_SENTINEL) {
      for (int j = 0; j < cap_r; ++j) {
        if (bkey[j] == key) {
          hit = j;
          break;
        }
      }
    }
    gke[s] = hit >= 0 ? gk[o] : K(KEY_SENTINEL);
    for (int q = 0; q < c; ++q) {
      const int src = col_src[q];
      float v = 0.f;
      if (hit >= 0)
        v = src >= 0 ? pv[(b * cp + src) * cap_s + s] : bval[(-src - 1) * cap_r + hit];
      val[q * cap_s + s] = v;
    }
  }
  __syncthreads();

  // slot of each row: the lowest row with the same masked key; cap_s = none
  for (int s = threadIdx.x; s < cap_s; s += blockDim.x) {
    const K g = gke[s];
    int r = cap_s;
    if (g != K(KEY_SENTINEL)) {
      r = s;
      for (int i = 0; i < s; ++i) {
        if (gke[i] == g) {
          r = i;
          break;
        }
      }
    }
    rep[s] = r;
  }
  __syncthreads();

  // the owner of each slot counts and sums its rows, in row order
  for (int s = threadIdx.x; s < cap_s; s += blockDim.x) {
    const long long o = b * cap_s + s;
    const bool owner = rep[s] == s;
    int cnt = 0, last = s;
    if (owner) {
      for (int i = s; i < cap_s; ++i) {
        if (rep[i] == s) {
          ++cnt;
          last = i;
        }
      }
    }
    pk[o] = owner ? gke[s] : K(KEY_SENTINEL);
    pc[o] = cnt;
    for (int q = 0; q < c; ++q) {
      float acc = 0.f;
      if (owner) {
        for (int i = s; i <= last; ++i)
          if (rep[i] == s) acc += val[q * cap_s + i];
      }
      ps[(b * c + q) * cap_s + s] = acc;
    }
  }
}

template <typename K>
static int launch(const void* bkeys, const void* bvals, const void* probe, const void* gk,
                  const void* pv, const void* block_part, const void* col_src,
                  long long num_blocks, int num_parts, int cap_r, int cap_s, int cb, int cp,
                  int c, void* pk, void* ps, void* pc, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cap_s) * (sizeof(K) + sizeof(int)) +
                      static_cast<size_t>(cap_r) * sizeof(int) * (1 + cb) +
                      static_cast<size_t>(c) * cap_s * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_agg_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = cap_s < 256 ? ((cap_s + 31) / 32) * 32 : 256;
  probe_agg_kernel<K><<<static_cast<unsigned>(num_blocks), threads, smem, stream>>>(
      static_cast<const int*>(bkeys), static_cast<const float*>(bvals),
      static_cast<const int*>(probe), static_cast<const K*>(gk), static_cast<const float*>(pv),
      static_cast<const int*>(block_part), static_cast<const int*>(col_src), num_parts, cap_r,
      cap_s, cb, cp, c, static_cast<K*>(pk), static_cast<float*>(ps), static_cast<int*>(pc));
  return launch_status();
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
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8)
    return launch<long long>(bkeys, bvals, probe, gk, pv, block_part, col_src, num_blocks,
                             num_parts, cap_r, cap_s, cb, cp, c, pk, ps, pc, st);
  return launch<int>(bkeys, bvals, probe, gk, pv, block_part, col_src, num_blocks, num_parts,
                     cap_r, cap_s, cb, cp, c, pk, ps, pc, st);
}
