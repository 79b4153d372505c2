// Shared device code of the score and streaming top-k kernels.
//
// Packed sketches arrive as PyTorch int32 storage and are read as uint32_t:
// the bits are the reference's uint32 words.
//
// and_popcount_tile computes one TQ x TC tile of AND-popcount counts
// (TQ = TC = 64) with 256 threads, each holding a 4 x 4 block of int32 sums in
// registers. The word axis is walked in TW = 32-word slabs staged in shared
// memory, transposed ([word][row], one word of padding per row of the
// transpose) so that the global loads are coalesced along a row and both the
// stores and the reads in the inner loop are free of bank conflicts. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j, i, j < 4.
//
// The work is Q*C*W AND + POPC + ADD, integer work that no tensor core does
// here: the kernels are bound by operations, not bytes. The epilogue is
// float32 throughout; the build uses --fmad=false and no fast math, so each
// operation rounds where the plain version's does.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int TQ = 64;
constexpr int TC = 64;
constexpr int TW = 32;
constexpr int THREADS = 256;

enum Measure { COUNTS = 0, IP = 1, HAMMING = 2, JACCARD = 3, COSINE = 4 };

struct Staging {
  uint32_t a[TW][TQ + 1];
  uint32_t b[TW][TC + 1];
};

__device__ __forceinline__ void and_popcount_tile(
    const uint32_t* __restrict__ A, int Q, const uint32_t* __restrict__ B, int C,
    int W, int q0, int c0, Staging& st, int acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += TW) {
    __syncthreads();  // the previous slab has been consumed
#pragma unroll
    for (int r = 0; r < (TQ * TW) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx / TW;
      const int w = idx % TW;
      const int gq = q0 + row;
      const int gw = w0 + w;
      st.a[w][row] = (gq < Q && gw < W) ? A[(size_t)gq * W + gw] : 0u;
      const int gc = c0 + row;
      st.b[w][row] = (gc < C && gw < W) ? B[(size_t)gc * W + gw] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int w = 0; w < TW; ++w) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = st.a[w][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = st.b[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(a[i] & b[j]);
    }
  }
}

// The fused estimator epilogue (kernels/popcount_sim.py::_epilogue).
// card(c) = d[c] * inv, where d is the (N + 1)-entry float32 table of
// ln(max(N - c, 0.5)) - ln N the host builds once per N
// (hopper/ref.py::log_ratio_table), so a pair costs three cached loads, not
// three logf; counts outside [0, N] clamp to its ends as the reference clips.
// IP = card_a + card_b - card_u cancels most of its digits, so single
// roundings decide the result to ~1e-5: the multiply-adds below are fused
// (__fmaf_rn) exactly where XLA fuses them in the reference kernel, per
// measure, and every other operation rounds on its own (--fmad=false).
__device__ __forceinline__ float epilogue(int count, int na, int nb, int measure,
                                          const float* __restrict__ d, float inv,
                                          int n_bins) {
  if (measure == COUNTS) return (float)count;
  const float d_a = __ldg(d + min(max(na, 0), n_bins));
  const float d_b = __ldg(d + min(max(nb, 0), n_bins));
  const float d_u = __ldg(d + min(max(na + nb - count, 0), n_bins));
  const float card_a = d_a * inv;
  const float card_b = d_b * inv;
  const float card_u = d_u * inv;
  if (measure == COSINE) {
    const float ip = fmaxf(__fmaf_rn(-d_u, inv, card_a + card_b), 0.0f);
    return fminf(fmaxf(ip / sqrtf(fmaxf(card_a * card_b, 1e-18f)), 0.0f), 1.0f);
  }
  const float sum_ab = __fmaf_rn(d_b, inv, card_a);
  if (measure == JACCARD) {
    const float ip = fmaxf(sum_ab - card_u, 0.0f);
    return fminf(fmaxf(ip / fmaxf(card_u, 1e-9f), 0.0f), 1.0f);
  }
  const float ip = fmaxf(__fmaf_rn(-d_u, inv, sum_ab), 0.0f);
  if (measure == IP) return ip;
  return fmaxf(sum_ab - 2.0f * ip, 0.0f);  // HAMMING
}

}  // namespace repro

// Name of a CUDA error code, for the Python side's messages.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
