// Hash-mode BinSketch construction: raw feature indices -> packed sketch
// words, the multiply-shift map computed in the kernel.
//
// Replaces kernels/hash_build.py::hash_build_kernel. For huge d there is no
// Psi table: an index i maps to bin ((a*i + b) mod 2^32) mod N. Mapping
// first and building second costs one more pass over the (B, P) bin ids in
// device memory; here the raw indices are read once and hashed in
// registers. The TPU kernel compares every bin against every target bin of
// a tile, because a TPU has no scatter; here, as in sketch_build.cu, each
// block owns one row, builds its W-word bitmap in shared memory with
// atomicOr and writes it out once.
//
// The multiply is done in uint32_t: a * (uint32_t)i + b wraps mod 2^32 as
// the reference specifies (a signed multiply would overflow, which C++
// leaves undefined). The modulus is the true N, so bits >= N are never set.
// Negative indices are pads and set no bit.
//
// idx: (B, P) int32.  coeffs: (2,) uint32 (a, b), read on the device, so
// the caller never waits for them.  out: (B, W) uint32, W = ceil(N / 32).
//
// Bound: bytes, B*P*4 read and B*W*4 written. W*4 bytes of shared memory a
// block (the wrapper keeps W under the 48 KB default).
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void hash_build_kernel(const int* __restrict__ idx, int P,
                                  const uint32_t* __restrict__ coeffs, uint32_t n_bins,
                                  int W, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t bitmap[];
  const size_t row = blockIdx.x;
  const uint32_t a = __ldg(coeffs);
  const uint32_t b = __ldg(coeffs + 1);
  for (int w = threadIdx.x; w < W; w += blockDim.x) bitmap[w] = 0u;
  __syncthreads();
  const int* r = idx + row * (size_t)P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int i = r[p];
    if (i >= 0) {
      const uint32_t bin = (a * (uint32_t)i + b) % n_bins;
      atomicOr(&bitmap[bin >> 5], 1u << (bin & 31u));
    }
  }
  __syncthreads();
  uint32_t* o = out + row * (size_t)W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) o[w] = bitmap[w];
}

}  // namespace

extern "C" int hash_build(const void* idx, int B, int P, const void* coeffs, int n_bins,
                          int W, void* out, void* stream) {
  if (B > 0) {
    hash_build_kernel<<<B, kThreads, W * sizeof(uint32_t),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), P, static_cast<const uint32_t*>(coeffs),
        static_cast<uint32_t>(n_bins), W, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
