// Fused streaming score -> top-k over a packed corpus.
//
// Replaces kernels/topk_stream.py::sketch_topk_kernel. The TPU kernel walks
// the corpus as a sequential grid axis and keeps a running top-k resident
// across steps with a bitonic sort network. Blocks on this card run in
// parallel and carry nothing from one to the next, so the work is two passes:
//
// 1. sketch_topk_partial_kernel: grid (corpus split, query tile), one
//    persistent block per SM. A block counts its contiguous range of 128-row
//    corpus tiles against 64 or 128 queries on the tensor cores (the binary
//    wgmma mainloop of common.cuh), turns each tile's counts into scores in
//    the accumulator registers (epilogue in float32, no branch a score), and
//    filters them there: a thread holds 2 query rows, so each row's current
//    k_pad-th key is a register, and only a score beating it takes a slot of
//    that row's candidate buffer in shared memory (atomicAdd on a count).
//    Once per tile a warp a row folds the buffer into the row's running
//    top-k_pad list in shared memory (a bitonic sort and merge across the
//    warp for k_pad <= 32, its depth set by the count; insertion above),
//    and the thresholds are read again.
//    After the first tiles almost every score stops at one comparison in
//    registers. The block writes its lists to `partial` (Q, splits, k_pad).
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
// Bound: the bytes, (Q + C)*W*4 + 8*C read and Q*k*8 written, or the
// Q*C*32W bit-ANDs and adds on the tensor cores, whichever is larger (the
// two are close at the serving shape); the time goes to the copies into
// shared memory, the epilogue and the filter (common.cuh).
// Lists take rows x k_pad x 8 bytes of shared memory, so the launch plan
// (hopper/popcount_sim.py::launch_plan) drops to 64 query rows a block
// where 128 do not fit at that k_pad. The filter's state keeps a block at two
// warpgroups (TOPK_WARPGROUPS), so a 256-query chunk is two query tiles and
// reads the corpus twice, the second time mostly from L2.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace repro;
using Key = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;

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

// The score of a list's last key, or the lowest finite float while the list
// is not full: every score (>= 0, or -inf for none) compares below or equal.
__device__ __forceinline__ float threshold_score(Key key) {
  float s;
  int id;
  decode_key(key, &s, &id);
  return key == 0ull ? -FLT_MAX : s;
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

// Fold the keys of lanes [0, n) (1 <= n <= 32; 0 in the other lanes) into
// the descending list[0, kp) held in shared memory, kp <= 32: a bitonic sort
// of the first p = next_pow2(n) lanes, then, with m = max(kp, p), the top m
// of keys and list as the pairwise max of the list and the reversed keys (a
// bitonic sequence) and a bitonic merge of it. log2(p)(log2(p) + 1)/2 +
// log2(m) shuffle steps, where warp_offer inserts one key at a time through
// shared memory.
__device__ void warp_merge(Key* list, int kp, Key key, int n, int lane) {
  const int p = n > 1 ? 1 << (32 - __clz(n - 1)) : 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key other = __shfl_xor_sync(kFull, key, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      key = keep_max ? (key > other ? key : other) : (key < other ? key : other);
    }
  }
  const int m = kp > p ? kp : p;
  const Key mine = lane < kp ? list[lane] : 0ull;
  const Key theirs = __shfl_sync(kFull, key, (m - 1 - lane) & 31);
  key = lane >= m ? 0ull : (mine > theirs ? mine : theirs);
  for (int stride = m >> 1; stride > 0; stride >>= 1) {
    const Key other = __shfl_xor_sync(kFull, key, stride);
    key = (lane & stride) == 0 ? (key > other ? key : other) : (key < other ? key : other);
  }
  if (lane < kp) list[lane] = key;
  __syncwarp();
}

constexpr int CAND = 32;  // candidate slots a query row has in one round
// warpgroups a block at most: two keep the filter's state in registers; four
// would cap a thread at 128 registers and spill it to local memory
constexpr int TOPK_WARPGROUPS = 2;
constexpr int kNone = static_cast<int>(0xff800000u);  // -inf: no score at this position

// Put one score's key in its row's candidate buffer: true if it took a
// slot, false if the buffer is full this round.
__device__ __forceinline__ bool take_slot(Key key, int* count, Key* slots) {
  const int slot = atomicAdd(count, 1);
  if (slot >= CAND) return false;
  slots[slot] = key;
  return true;
}

size_t topk_smem_bytes(int warpgroups, int stages, int ks, int kp) {
  const size_t rows = (size_t)warpgroups * WG_ROWS;
  return (size_t)stages * ks * stage_bytes(static_cast<int>(rows)) + rows * kp * sizeof(Key) +
         rows * CAND * sizeof(Key) + rows * sizeof(int);
}

template <int VEC, int M>
__global__ void __launch_bounds__(TOPK_WARPGROUPS * WG_THREADS, 1)
sketch_topk_partial_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                           const int* __restrict__ na, const int* __restrict__ nb,
                           const int* __restrict__ valid, int Q, int C, int W,
                           const float* __restrict__ card, float inv, int n_bins,
                           int kp, int stages, int ks, int tiles_per_split,
                           Key* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows_a = (blockDim.x / WG_THREADS) * WG_ROWS;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int q0 = blockIdx.y * rows_a;
  const int n_tiles = (C + BN - 1) / BN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  Key* lists = reinterpret_cast<Key*>(smem + (size_t)stages * ks * stage_bytes(rows_a));  // rows_a x kp
  Key* cand = lists + rows_a * kp;                                    // rows_a x CAND
  int* n_cand = reinterpret_cast<int*>(cand + rows_a * CAND);         // rows_a
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = tid; i < rows_a * kp; i += blockDim.x) lists[i] = 0ull;
  for (int i = tid; i < rows_a; i += blockDim.x) n_cand[i] = 0;
  // (the mainloop's first barrier orders these before any use)

  const bool has_valid = valid != nullptr;
  int row[2], fa[2];
  Side sa[2];
  bool row_ok[2];
  Key thr[2] = {0ull, 0ull};  // the row's k_pad-th key: a score enters only above it
  float thr_s[2] = {-FLT_MAX, -FLT_MAX};  // its score: a score below it stops at one compare
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = acc_row(warp % 4, lane, 2 * h) + (warp / 4) * WG_ROWS;
    row_ok[h] = q0 + row[h] < Q;
    fa[h] = row_ok[h] ? na[q0 + row[h]] : 0;
    sa[h] = side<M>(fa[h], card, inv, n_bins);
  }
  count_tiles<VEC>(A, Q, B, C, W, q0, rows_a, t0, t1, smem, stages, ks,
                   [&](int c0, int (&acc)[N_ACC]) {
    // scores in place, as float bits; kNone for columns past C, masked
    // rows and query rows past Q. Every position is scored (columns past C
    // read column C - 1) and then selected, so the loop has no branch and
    // the scores' loads interleave.
#pragma unroll
    for (int v = 0; v < N_ACC; v += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + acc_col(lane, v + e);
        const int cc = min(c, C - 1);
        const bool ok = c < C && (!has_valid || __ldg(valid + cc) != 0);
        const int fb = M != COUNTS ? __ldg(nb + cc) : 0;
        const Side sb = side<M>(fb, card, inv, n_bins);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = v + 2 * h + e;
          const float score = epilogue<M>(acc[i], fa[h] + fb, sa[h], sb, card, inv, n_bins);
          acc[i] = ok && row_ok[h] ? __float_as_int(score) : kNone;
        }
      }
    }
    // Threshold filter: a score beating its row's k_pad-th key takes a slot
    // of the row's candidate buffer; a warp a row then offers the buffer to
    // the row's list. A row with more than CAND such scores in this tile
    // (the first tiles) goes round again against the raised threshold; the
    // scores already offered are marked in `spent`, not overwritten, so the
    // accumulators are never written on a divergent path.
    unsigned spent[N_ACC / 32] = {0u, 0u};
    for (;;) {
      bool pending = false;
#pragma unroll
      for (int v = 0; v < N_ACC; ++v) {
        const int h = (v >> 1) & 1;
        const float s = __int_as_float(acc[v]);
        if (!(s >= thr_s[h]) || ((spent[v >> 5] >> (v & 31)) & 1u)) continue;
        const Key key = make_key(s, c0 + acc_col(lane, v));
        if (key <= thr[h]) continue;
        if (take_slot(key, n_cand + row[h], cand + row[h] * CAND)) {
          spent[v >> 5] |= 1u << (v & 31);
        } else {
          pending = true;
        }
      }
      __syncthreads();
      for (int r = warp; r < rows_a; r += n_warps) {
        const int n = min(n_cand[r], CAND);  // warp-uniform
        if (n == 0) continue;
        const Key key = lane < n ? cand[r * CAND + lane] : 0ull;
        if (kp <= 32) {
          warp_merge(lists + r * kp, kp, key, n, lane);
        } else {
          warp_offer(lists + r * kp, kp, key, lane);
        }
        __syncwarp();
        if (lane == 0) n_cand[r] = 0;
      }
      const bool again = __syncthreads_or(pending);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thr[h] = lists[row[h] * kp + kp - 1];
        thr_s[h] = threshold_score(thr[h]);
      }
      if (!again) break;
    }
  });
  __syncthreads();
  for (int i = tid; i < rows_a * kp; i += blockDim.x) {
    const int q = q0 + i / kp;
    if (q < Q) partial[((size_t)q * splits + split) * kp + (i % kp)] = lists[i];
  }
}

using PartialLaunch = cudaError_t (*)(dim3, int, size_t, cudaStream_t, const uint32_t*,
                                      const uint32_t*, const int*, const int*, const int*, int,
                                      int, int, const float*, float, int, int, int, int, int,
                                      Key*);

template <int VEC, int M>
cudaError_t launch_partial(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                           const uint32_t* a, const uint32_t* b, const int* na, const int* nb,
                           const int* valid, int Q, int C, int W, const float* card, float inv,
                           int n_bins, int kp, int stages, int ks, int tiles_per_split,
                           Key* partial) {
  cudaError_t err = set_dynamic_smem((const void*)sketch_topk_partial_kernel<VEC, M>, smem);
  if (err != cudaSuccess) return err;
  sketch_topk_partial_kernel<VEC, M><<<grid, threads, smem, stream>>>(
      a, b, na, nb, valid, Q, C, W, card, inv, n_bins, kp, stages, ks, tiles_per_split,
      partial);
  return cudaGetLastError();
}

template <int VEC>
PartialLaunch partial_launch(int measure) {
  switch (measure) {
    case COUNTS: return launch_partial<VEC, COUNTS>;
    case IP: return launch_partial<VEC, IP>;
    case HAMMING: return launch_partial<VEC, HAMMING>;
    case JACCARD: return launch_partial<VEC, JACCARD>;
    case COSINE: return launch_partial<VEC, COSINE>;
  }
  return nullptr;
}

constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;

__global__ void __launch_bounds__(kMergeThreads)
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

}  // namespace

extern "C" int sketch_topk_partial(const void* a, const void* b, const void* na,
                                   const void* nb, const void* valid, int Q, int C,
                                   int W, int measure, const void* card, float inv, int n_bins,
                                   int k_pad, int warpgroups, int stages, int ks, int splits,
                                   int tiles_per_split, long long smem_bytes, int vec16,
                                   void* partial, void* stream) {
  if (Q <= 0 || splits <= 0) return static_cast<int>(cudaGetLastError());
  const PartialLaunch fn = vec16 ? partial_launch<16>(measure) : partial_launch<4>(measure);
  if (fn == nullptr || warpgroups < 1 || warpgroups > TOPK_WARPGROUPS ||
      stages < MIN_STAGES || stages > MAX_STAGES || ks < 1 || ks > MAX_STAGE_STEPS ||
      (size_t)smem_bytes != topk_smem_bytes(warpgroups, stages, ks, k_pad))
    return static_cast<int>(cudaErrorInvalidValue);  // the launch plan disagrees with this file
  const dim3 grid(splits, (Q + warpgroups * WG_ROWS - 1) / (warpgroups * WG_ROWS));
  return static_cast<int>(fn(grid, warpgroups * WG_THREADS, smem_bytes,
                             static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(a),
                             static_cast<const uint32_t*>(b), static_cast<const int*>(na),
                             static_cast<const int*>(nb), static_cast<const int*>(valid), Q, C,
                             W, static_cast<const float*>(card), inv, n_bins, k_pad, stages, ks,
                             tiles_per_split, static_cast<Key*>(partial)));
}

extern "C" int sketch_topk_merge(const void* partial, int Q, int splits, int k_pad,
                                 void* out_s, void* out_i, void* stream) {
  if (Q > 0) {
    const size_t smem = (size_t)kMergeWarps * k_pad * sizeof(Key);
    cudaError_t err = set_dynamic_smem((const void*)sketch_topk_merge_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (Q + kMergeWarps - 1) / kMergeWarps;
    sketch_topk_merge_kernel<<<blocks, kMergeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Key*>(partial), Q, splits, k_pad, static_cast<float*>(out_s),
        static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}
