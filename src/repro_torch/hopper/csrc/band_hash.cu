// Banded LSH keys over packed sketch words (the banded prefilter's index keys).
//
// Replaces kernels/band_hash.py::band_hash_kernel. Band t of a row covers
// words [t*wpb, (t+1)*wpb), and its key is the seeded xorshift-multiply
// chain, in uint32 wraparound:
//
//   h = SEED * (t + 1);  for each word x: h = (h ^ x) * PRIME;  h ^= h >> 15
//
// The TPU kernel needs its word axis padded to nb_eff * wpb with zeros; here
// a word index >= W reads as 0, so the caller's (B, W) words go in as they
// are and no padded copy is made. uint32_t arithmetic is the wraparound the
// reference specifies, and >> on uint32_t is the logical shift.
//
// One thread per (row, band) runs the chain over the band's wpb words. A
// warp covers 32 consecutive (row, band) pairs, so its first loads touch
// every cache line of its rows and the later words of the chain come from
// L1.
//
// src: (B, W) uint32.  out: (B, nb_eff) uint32.
//
// Bound: bytes, 4*B*W read and 4*B*nb_eff written; the chain is two
// integer operations a word besides the multiply.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSeed = 0x9E3779B9u;
constexpr uint32_t kPrime = 0x85EBCA6Bu;

__global__ void band_hash_kernel(const uint32_t* __restrict__ src, int B, int W,
                                 int nb_eff, int wpb, uint32_t* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nb_eff) return;
  const size_t b = idx / nb_eff;
  const int t = (int)(idx % nb_eff);
  const uint32_t* row = src + b * (size_t)W;
  const int w0 = t * wpb;
  uint32_t h = kSeed * (uint32_t)(t + 1);
  for (int j = 0; j < wpb; ++j) {
    const int w = w0 + j;
    const uint32_t x = w < W ? __ldg(row + w) : 0u;
    h = (h ^ x) * kPrime;
    h ^= h >> 15;
  }
  out[idx] = h;
}

}  // namespace

extern "C" int band_hash(const void* src, int B, int W, int nb_eff, int wpb, void* out,
                         void* stream) {
  const size_t n = (size_t)B * nb_eff;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    band_hash_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), B, W, nb_eff, wpb, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
