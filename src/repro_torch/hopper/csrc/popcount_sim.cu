// Packed AND-popcount scoring with the fused estimator epilogue, on the
// tensor cores.
//
// Replaces kernels/popcount_sim.py::sketch_score_kernel (and score_kernel,
// its counts-only form: measure COUNTS). A persistent block per SM (grid:
// corpus split x query tile; up to four warpgroups, 256 query rows, so a
// serving chunk is one query tile and the corpus is read once) runs the
// binary wgmma mainloop of common.cuh over its range of 128-row corpus
// tiles; each tile's counts go through the float32 epilogue in registers
// (one kernel a measure, no branch a score) and out to the (Q, C) float32
// matrix, staged per warp through shared memory so that each store
// instruction writes 32 consecutive floats of one row (a full 128-byte line
// when aligned), with the streaming hint: the output is not read again here.
//
// a: (Q, W), b: (C, W) uint32 words; na: (Q,), nb: (C,) int32 fill counts;
// card, inv: the (N + 1,) float32 log table and 1/log1p(-1/N) (unused for
// COUNTS); out: (Q, C) float32.
//
// Bound: Q*C*32W bit-ANDs and adds on the tensor cores against (Q + C)*W*4
// bytes read and Q*C*4 written; at the serving shape (256 x 300,000 x 184)
// the output's bytes set the bound, and the time goes to the copies into
// shared memory and the epilogue (common.cuh).
//
// mma_b1_loop times the instruction alone: each block runs `iters`
// m64n128k256 b1 wgmma per warpgroup on operands resident in shared memory,
// with no device-memory traffic but one int a thread at the end.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int OUT_STRIDE = 33;  // floats of a staged row, padded: conflict-free reads
constexpr int OUT_WARP_BYTES = 16 * OUT_STRIDE * 4;

size_t score_smem_bytes(int warpgroups, int stages, int ks) {
  return (size_t)stages * ks * stage_bytes(warpgroups * WG_ROWS) +
         (size_t)warpgroups * 4 * OUT_WARP_BYTES;
}

template <int VEC, int M>
__global__ void __launch_bounds__(MAX_WARPGROUPS * WG_THREADS, 1)
sketch_score_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                    const int* __restrict__ na, const int* __restrict__ nb, int Q, int C,
                    int W, const float* __restrict__ card, float inv, int n_bins, int stages,
                    int ks, int tiles_per_split, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows_a = (blockDim.x / WG_THREADS) * WG_ROWS;
  const int q0 = blockIdx.y * rows_a;
  const int n_tiles = (C + BN - 1) / BN;
  const int t0 = blockIdx.x * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* staged = reinterpret_cast<float*>(smem + (size_t)stages * ks * stage_bytes(rows_a) +
                                           warp * OUT_WARP_BYTES);
  const int r_base = q0 + (warp / 4) * WG_ROWS + 16 * (warp % 4);  // this warp's 16 rows
  int fa[2];
  Side sa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = r_base + (lane >> 2) + 8 * h;
    fa[h] = q < Q ? na[q] : 0;
    sa[h] = side<M>(fa[h], card, inv, n_bins);
  }
  count_tiles<VEC>(A, Q, B, C, W, q0, rows_a, t0, t1, smem, stages, ks,
                   [&](int c0, int (&acc)[N_ACC]) {
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {  // 32 columns at a time
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = 4 * (4 * g + jj) + e;  // row h adds 2 * h
          const int col = acc_col(lane, v);
          const int c = c0 + col;
          const int fb = M != COUNTS ? __ldg(nb + min(c, C - 1)) : 0;  // no branch
          const Side sb = side<M>(fb, card, inv, n_bins);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            staged[((lane >> 2) + 8 * h) * OUT_STRIDE + col - 32 * g] =
                epilogue<M>(acc[v + 2 * h], fa[h] + fb, sa[h], sb, card, inv, n_bins);
        }
      }
      __syncwarp();
      const int c = c0 + 32 * g + lane;
      if (c < C) {
        for (int r = 0; r < 16; ++r) {
          if (r_base + r < Q) __stcs(out + (size_t)(r_base + r) * C + c, staged[r * OUT_STRIDE + lane]);
        }
      }
      __syncwarp();
    }
  });
}

using ScoreLaunch = cudaError_t (*)(dim3, int, size_t, cudaStream_t, const uint32_t*,
                                    const uint32_t*, const int*, const int*, int, int, int,
                                    const float*, float, int, int, int, int, float*);

template <int VEC, int M>
cudaError_t launch_score(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                         const uint32_t* a, const uint32_t* b, const int* na, const int* nb,
                         int Q, int C, int W, const float* card, float inv, int n_bins,
                         int stages, int ks, int tiles_per_split, float* out) {
  cudaError_t err = set_dynamic_smem((const void*)sketch_score_kernel<VEC, M>, smem);
  if (err != cudaSuccess) return err;
  sketch_score_kernel<VEC, M><<<grid, threads, smem, stream>>>(
      a, b, na, nb, Q, C, W, card, inv, n_bins, stages, ks, tiles_per_split, out);
  return cudaGetLastError();
}

template <int VEC>
ScoreLaunch score_launch(int measure) {
  switch (measure) {
    case COUNTS: return launch_score<VEC, COUNTS>;
    case IP: return launch_score<VEC, IP>;
    case HAMMING: return launch_score<VEC, HAMMING>;
    case JACCARD: return launch_score<VEC, JACCARD>;
    case COSINE: return launch_score<VEC, COSINE>;
  }
  return nullptr;
}

__global__ void __launch_bounds__(MAX_WARPGROUPS * WG_THREADS, 1)
mma_b1_loop_kernel(int iters, int* out) {
  constexpr int ROWS_A = MAX_WARPGROUPS * WG_ROWS;
  __shared__ __align__(128) unsigned char tile[stage_bytes(ROWS_A)];
  for (int i = threadIdx.x; i < stage_bytes(ROWS_A) / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(tile)[i] = 0x9E3779B9u * (i + 1);
  fence_proxy_async();
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  const uint64_t da = smem_desc(base + (threadIdx.x / WG_THREADS) * (WG_ROWS / 8) * 256);
  const uint64_t db = smem_desc(base + (ROWS_A / 8) * 256);
  int acc[N_ACC];
#pragma unroll
  for (int v = 0; v < N_ACC; ++v) acc[v] = 0;
  for (int i = 0; i < iters; ++i) {
    wgmma_fence();
    mma_b1(acc, da, db, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  int s = 0;
#pragma unroll
  for (int v = 0; v < N_ACC; ++v) s += acc[v];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int sketch_score(const void* a, const void* b, const void* na, const void* nb,
                            int Q, int C, int W, int measure, const void* card,
                            float inv, int n_bins, void* out, int warpgroups, int stages,
                            int ks, int splits, int tiles_per_split, long long smem_bytes,
                            int vec16, void* stream) {
  if (Q <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const ScoreLaunch fn = vec16 ? score_launch<16>(measure) : score_launch<4>(measure);
  if (fn == nullptr || warpgroups < 1 || warpgroups > MAX_WARPGROUPS ||
      stages < MIN_STAGES || stages > MAX_STAGES || ks < 1 || ks > MAX_STAGE_STEPS ||
      (size_t)smem_bytes != score_smem_bytes(warpgroups, stages, ks))
    return static_cast<int>(cudaErrorInvalidValue);  // the launch plan disagrees with this file
  const dim3 grid(splits, (Q + warpgroups * WG_ROWS - 1) / (warpgroups * WG_ROWS));
  return static_cast<int>(fn(grid, warpgroups * WG_THREADS, smem_bytes,
                             static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(a),
                             static_cast<const uint32_t*>(b), static_cast<const int*>(na),
                             static_cast<const int*>(nb), Q, C, W,
                             static_cast<const float*>(card), inv, n_bins, stages, ks,
                             tiles_per_split, static_cast<float*>(out)));
}

// Runs `iters` b1 wgmma a warpgroup, MAX_WARPGROUPS warpgroups in each of
// `blocks` blocks; out holds blocks * MAX_WARPGROUPS * 128 ints.
extern "C" int mma_b1_loop(int blocks, int iters, void* out, void* stream) {
  mma_b1_loop_kernel<<<blocks, MAX_WARPGROUPS * WG_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
