// Packed AND-popcount scoring with the fused estimator epilogue.
//
// Replaces kernels/popcount_sim.py::sketch_score_kernel (and score_kernel,
// its counts-only form: measure COUNTS). Each block computes one 64 x 64 tile
// of the (Q, C) output: counts[q, c] = sum_w popcount(a[q, w] & b[c, w]) in
// registers (common.cuh), then the epilogue in float32, written once.
//
// a: (Q, W), b: (C, W) uint32 words; na: (Q,), nb: (C,) int32 fill counts;
// card, inv: the (N + 1,) float32 log table and 1/log1p(-1/N) (unused for COUNTS);
// out: (Q, C) float32.
//
// Bound: operations. Q*C*W AND + POPC + ADD against (Q + C)*W*4 bytes read
// and Q*C*4 written; each tile reuses every staged word 64 times.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(THREADS)
sketch_score_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                    const int* __restrict__ na, const int* __restrict__ nb, int Q,
                    int C, int W, int measure, const float* __restrict__ card, float inv, int n_bins,
                    float* __restrict__ out) {
  __shared__ Staging st;
  const int q0 = blockIdx.y * TQ;
  const int c0 = blockIdx.x * TC;
  int acc[4][4];
  and_popcount_tile(A, Q, B, C, W, q0, c0, st, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
    const int fa = na[q];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= C) continue;
      out[(size_t)q * C + c] = epilogue(acc[i][j], fa, nb[c], measure, card, inv, n_bins);
    }
  }
}

}  // namespace

extern "C" int sketch_score(const void* a, const void* b, const void* na, const void* nb,
                            int Q, int C, int W, int measure, const void* card,
                            float inv, int n_bins, void* out, void* stream) {
  if (Q > 0 && C > 0) {
    dim3 grid((C + TC - 1) / TC, (Q + TQ - 1) / TQ);
    sketch_score_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int*>(na), static_cast<const int*>(nb), Q, C, W, measure,
        static_cast<const float*>(card), inv, n_bins, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
