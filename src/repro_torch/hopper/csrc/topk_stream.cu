// Fused streaming score -> top-k over a packed corpus.
//
// Replaces kernels/topk_stream.py::sketch_topk_kernel. The TPU kernel walks
// the corpus as a sequential grid axis and keeps a running top-k resident
// across steps with a bitonic sort network. Blocks on this card run in
// parallel and carry nothing from one to the next, so the work is two passes:
//
// 1. sketch_topk_partial_kernel: grid (corpus split, query tile). A block
//    scores its contiguous range of 64-row corpus tiles against 64 queries
//    (counts in registers, common.cuh; epilogue in float32), parks the 64 x 64
//    scores in shared memory, and one warp per query row offers them to that
//    row's running top-k_pad list in shared memory. A candidate enters only if
//    it beats the list's last key, so after the first tiles almost every
//    score is dropped with one comparison. The block writes its lists to
//    `partial` (Q, splits, k_pad).
// 2. sketch_topk_merge_kernel: one warp per query folds the splits' lists
//    into one with the same insertion, then decodes scores and ids.
//
// The order is the reference's (_compare_exchange): score descending, then
// global id ascending. Both are packed into one 64-bit key: the float's bits
// made order-preserving as an unsigned integer, above ~id. Key 0 is "empty"
// (below every real key) and decodes to score -inf, id -1. Invalid rows
// (valid[c] == 0) and rows past C are never offered. Only (Q, k) results and
// the (Q, splits, k_pad) partials reach device memory; the (Q, C) matrix
// never does.
//
// Bound: operations, as the score kernel (Q*C*W AND + POPC + ADD); the
// bytes are (Q + C)*W*4 + 8*C read and Q*k*8 written.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace repro;
using Key = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerWarp = TQ / (THREADS / 32);

__device__ __forceinline__ Key make_key(float s, int id) {
  const uint32_t u = __float_as_uint(s + 0.0f);  // -0.0 -> +0.0: equal scores tie
  const uint32_t hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(hi) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(id));
}

__device__ __forceinline__ void decode_key(Key key, float* score, int* id) {
  if (key == 0ull) {
    *score = -__int_as_float(0x7f800000);  // -inf
    *id = -1;
    return;
  }
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t u = (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
  *score = __uint_as_float(u);
  *id = static_cast<int>(~static_cast<uint32_t>(key));
}

// Insert x into the descending list[0, kp) held in shared memory; x must beat
// list[kp - 1]. All 32 lanes of the warp call it with the same x.
__device__ void warp_insert(Key* list, int kp, Key x, int lane) {
  int pos = 0;
  for (int base = 0; base < kp; base += 32) {
    const int i = base + lane;
    pos += __popc(__ballot_sync(kFull, i < kp && list[i] > x));
  }
  // shift the tail down by one, highest 32-slot chunk first, so every read
  // of list[i - 1] happens before that slot is overwritten
  for (int base = ((kp - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const bool write = i < kp && i >= pos;
    const Key v = !write ? 0ull : (i == pos ? x : list[i - 1]);
    __syncwarp();
    if (write) list[i] = v;
    __syncwarp();
  }
}

// Offer one key per lane to the list; lanes holding 0 offer nothing.
__device__ __forceinline__ void warp_offer(Key* list, int kp, Key key, int lane) {
  unsigned mask = __ballot_sync(kFull, key > list[kp - 1]);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const Key x = __shfl_sync(kFull, key, src);
    warp_insert(list, kp, x, lane);
    mask &= ~(1u << src);
    mask &= __ballot_sync(kFull, key > list[kp - 1]);
  }
}

__global__ void __launch_bounds__(THREADS)
sketch_topk_partial_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                           const int* __restrict__ na, const int* __restrict__ nb,
                           const int* __restrict__ valid, int Q, int C, int W,
                           int measure, const float* __restrict__ card, float inv, int n_bins, int kp,
                           int tiles_per_split, Key* __restrict__ partial) {
  __shared__ Staging st;
  __shared__ float sc[TQ][TC + 1];
  extern __shared__ Key lists[];  // TQ * kp, each row descending
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < TQ * kp; i += THREADS) lists[i] = 0ull;

  const int n_tiles = (C + TC - 1) / TC;
  const int t_end = min((split + 1) * tiles_per_split, n_tiles);
  for (int t = split * tiles_per_split; t < t_end; ++t) {
    const int c0 = t * TC;
    int acc[4][4];
    and_popcount_tile(A, Q, B, C, W, q0, c0, st, acc);  // opens with __syncthreads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      const int fa = q < Q ? na[q] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        float v = -__int_as_float(0x7f800000);
        if (c < C && (valid == nullptr || valid[c] != 0))
          v = epilogue(acc[i][j], fa, nb[c], measure, card, inv, n_bins);
        sc[ty + 16 * i][tx + 16 * j] = v;
      }
    }
    __syncthreads();
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (q0 + row >= Q) break;  // warp-uniform
      Key* list = lists + row * kp;
      for (int half = 0; half < TC; half += 32) {
        const int cl = half + lane;
        const float v = sc[row][cl];
        const Key key = (v == -__int_as_float(0x7f800000)) ? 0ull : make_key(v, c0 + cl);
        warp_offer(list, kp, key, lane);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < TQ * kp; i += THREADS) {
    const int row = i / kp;
    const int q = q0 + row;
    if (q < Q) partial[((size_t)q * splits + split) * kp + (i % kp)] = lists[i];
  }
}

constexpr int kMergeWarps = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
sketch_topk_merge_kernel(const Key* __restrict__ partial, int Q, int splits, int kp,
                         float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ Key lists[];  // kMergeWarps * kp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= Q) return;  // warp-uniform; no block-wide barrier below
  Key* list = lists + warp * kp;
  for (int i = lane; i < kp; i += 32) list[i] = 0ull;
  __syncwarp();
  const Key* src = partial + (size_t)q * splits * kp;
  const int total = splits * kp;
  for (int base = 0; base < total; base += 32) {
    const Key key = base + lane < total ? src[base + lane] : 0ull;
    warp_offer(list, kp, key, lane);
  }
  __syncwarp();
  for (int i = lane; i < kp; i += 32) {
    float s;
    int id;
    decode_key(list[i], &s, &id);
    out_s[(size_t)q * kp + i] = s;
    out_i[(size_t)q * kp + i] = id;
  }
}

cudaError_t set_dynamic_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int sketch_topk_partial(const void* a, const void* b, const void* na,
                                   const void* nb, const void* valid, int Q, int C,
                                   int W, int measure, const void* card, float inv, int n_bins,
                                   int k_pad, int splits, int tiles_per_split,
                                   void* partial, void* stream) {
  if (Q > 0 && splits > 0) {
    const size_t smem = (size_t)TQ * k_pad * sizeof(Key);
    cudaError_t err = set_dynamic_smem((const void*)sketch_topk_partial_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(splits, (Q + TQ - 1) / TQ);
    sketch_topk_partial_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const int*>(na), static_cast<const int*>(nb),
        static_cast<const int*>(valid), Q, C, W, measure,
        static_cast<const float*>(card), inv, n_bins, k_pad,
        tiles_per_split, static_cast<Key*>(partial));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sketch_topk_merge(const void* partial, int Q, int splits, int k_pad,
                                 void* out_s, void* out_i, void* stream) {
  if (Q > 0) {
    const size_t smem = (size_t)kMergeWarps * k_pad * sizeof(Key);
    cudaError_t err = set_dynamic_smem((const void*)sketch_topk_merge_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (Q + kMergeWarps - 1) / kMergeWarps;
    sketch_topk_merge_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Key*>(partial), Q, splits, k_pad, static_cast<float*>(out_s),
        static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}
