// BinSketch construction: mapped bin ids -> packed sketch words.
//
// Replaces kernels/sketch_build.py::build_sketch_kernel. The TPU kernel
// compares every bin id against every target bin and OR-reduces, because a
// TPU has no scatter. Here each block owns one row and builds its W-word
// bitmap in shared memory with atomicOr, then writes it out once.
//
// bins: (B, P) int32, pad -1; ids outside [0, n_bins) set no bit.
// out:  (B, W) uint32 words, W = ceil(n_bins / 32).
//
// Bound: bytes. The kernel reads B*P*4 bytes and writes B*W*4; the
// shared-memory atomics are cheap next to that. W*4 bytes of shared memory a
// block (the wrapper keeps W under the 48 KB default).
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sketch_build_kernel(const int* __restrict__ bins, int P, int n_bins,
                                    int W, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t bitmap[];
  const size_t row = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) bitmap[w] = 0u;
  __syncthreads();
  const int* r = bins + row * (size_t)P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int t = r[p];
    if (t >= 0 && t < n_bins) atomicOr(&bitmap[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
  uint32_t* o = out + row * (size_t)W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) o[w] = bitmap[w];
}

}  // namespace

extern "C" int sketch_build(const void* bins, int B, int P, int n_bins, int W,
                            void* out, void* stream) {
  if (B > 0) {
    sketch_build_kernel<<<B, kThreads, W * sizeof(uint32_t),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bins), P, n_bins, W, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
