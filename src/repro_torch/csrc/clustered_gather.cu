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
// threads mostly hit the same or neighbouring cache lines.
//
// Design: a grid-stride loop, one element per thread per step, with no
// window: the card's caches absorb the clustering, so the kernel is right
// for any in-range index and needs no span check. Staging a window in shared
// memory is left for a later change.
#include <cstdint>

#include "common.cuh"

template <typename T>
__global__ void clustered_gather_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                                        long long n_src, long long n, T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long j = idx[i];
    out[i] = j >= 0 ? src[j < n_src ? j : n_src - 1] : T(0);
  }
}

// elem_bytes is 4 or 8; idx is int32; src has n_src >= 1 elements.
extern "C" int clustered_gather(const void* src, const void* idx, long long n_src, long long n,
                                int elem_bytes, void* out, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8) {
    clustered_gather_kernel<uint64_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint64_t*>(src), static_cast<const int*>(idx), n_src, n,
        static_cast<uint64_t*>(out));
  } else if (elem_bytes == 4) {
    clustered_gather_kernel<uint32_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint32_t*>(src), static_cast<const int*>(idx), n_src, n,
        static_cast<uint32_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
