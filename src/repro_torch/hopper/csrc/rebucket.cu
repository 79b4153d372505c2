// Sketch re-bucketing: packed rows at N bins folded to N' <= N bins, bin j
// ORed into bin j mod N'.
//
// Replaces kernels/rebucket.py::rebucket_kernel. Chunk q of a source row (bits
// [q*N', (q+1)*N')) lands on the output at bit offset 0, so output word w' of
// chunk q is a funnel shift of source words lo + w' and lo + w' + 1, with
// lo = (q*N') / 32 and shift s = (q*N') % 32. The TPU kernel shifts whole
// word slices and branches around s == 0 (a shift by 32 is undefined);
// __funnelshift_r is defined for s == 0 and needs no branch.
//
// One thread per (row, output word), looping over the ceil(N / N') chunks.
// Source words past W read as 0 and source bits >= N in the last word are
// masked here, so the caller's pad bits never leak into the fold; output
// bits >= N' (the next chunk's head) are masked once at the end.
//
// src: (B, W) uint32, W = ceil(N / 32).  out: (B, W') uint32, W' = ceil(N' / 32).
//
// Bound: launch latency at the shapes it runs at (a query chunk of 256 rows,
// once per distinct distilled width); its bytes bound is 4*B*(W + W').
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t src_word(const uint32_t* __restrict__ row, int i,
                                             int W, uint32_t last_mask) {
  if (i >= W) return 0u;
  const uint32_t v = row[i];
  return i == W - 1 ? (v & last_mask) : v;
}

__global__ void rebucket_kernel(const uint32_t* __restrict__ src, int B, int W,
                                int n_bins, int n_bins_new, int W_new,
                                uint32_t* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * W_new) return;
  const size_t b = idx / W_new;
  const int w = (int)(idx % W_new);
  const uint32_t* row = src + b * (size_t)W;
  const int tail = n_bins & 31;
  const uint32_t last_mask = tail ? ((1u << tail) - 1u) : 0xFFFFFFFFu;
  const int n_chunks = (n_bins + n_bins_new - 1) / n_bins_new;
  uint32_t acc = 0u;
  for (int q = 0; q < n_chunks; ++q) {
    const int lo_bit = q * n_bins_new;
    const int lo = (lo_bit >> 5) + w;
    const uint32_t x = src_word(row, lo, W, last_mask);
    const uint32_t y = src_word(row, lo + 1, W, last_mask);
    acc |= __funnelshift_r(x, y, (unsigned)(lo_bit & 31));
  }
  const int bits_left = n_bins_new - w * 32;  // >= 1 for every output word
  if (bits_left < 32) acc &= (1u << bits_left) - 1u;
  out[idx] = acc;
}

}  // namespace

extern "C" int rebucket(const void* src, int B, int W, int n_bins, int n_bins_new,
                        int W_new, void* out, void* stream) {
  const size_t n = (size_t)B * W_new;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    rebucket_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), B, W, n_bins, n_bins_new, W_new,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
