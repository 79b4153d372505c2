// Shared device code of the score and streaming top-k kernels: the binary
// tensor-core count mainloop and the float32 estimator epilogue.
//
// Packed sketches arrive as PyTorch int32 storage and are read as uint32_t:
// the bits are the reference's uint32 words.
//
// counts[q, c] = sum_w popcount(a[q, w] & b[c, w]) is a binary matrix product,
// A . B^T over bits, and Hopper's tensor cores compute exactly that:
// wgmma.mma_async.m64n128k256.s32.b1.b1.and.popc takes 64 query rows (M) and
// 128 corpus rows (N) of 256 bits (K: 8 words) from shared memory and adds
// their AND-popcounts into s32 registers. The counts are exact, so the
// epilogue sees the integers the SIMT loop it replaces computed. Bit order
// inside a word does not matter: A and B share it and the sum runs over all
// of K.
//
// The mainloop (count_tiles) walks one block's contiguous range of 128-row
// corpus tiles against its 64, 128 or 256 query rows (one consumer
// warpgroup each). Both operands stream through a ring of shared-memory
// stages of up to four k256 steps (128 bytes of each row), filled by
// cp.async with zero-fill: words >= W and rows past Q or C land as zeros and
// read nothing from device memory, so no padded copy exists anywhere. The
// queries are not kept resident, because 64 rows at W = 1024 would need
// 256 KB; they come again from L2 with every tile, and shared memory does
// not depend on W. The next stages load while the tensor cores work on this
// one, and one wgmma group stays in flight across the barrier of the next.
//
// N = 128 keeps a thread's accumulators at 64 registers, so four
// warpgroups fit a block and a 256-query chunk reads the corpus once. Each
// thread of a warpgroup ends a tile holding 2 query rows x 32 corpus columns
// of counts (the wgmma accumulator fragment, see acc_row/acc_col), which
// the kernels turn into scores in registers. What bounds the kernels on the
// card is not the tensor cores (Q*C*32W bit multiply-adds take 0.06 ms at
// the serving shape) but the copies into shared memory and the epilogue of
// each 64 x 128 tile: the epilogue is written without a branch a score so
// that the scores' table loads interleave. Bytes: (Q + C)*W*4 read.
//
// The epilogue is float32 throughout; the build uses --fmad=false and no fast
// math, so each operation rounds where the plain version's does (but see
// epilogue() for the last step).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int WG_THREADS = 128;         // one warpgroup
constexpr int WG_ROWS = 64;             // query rows of a warpgroup: wgmma M
constexpr int BN = 128;                 // corpus rows of a tile: wgmma N
constexpr int KW = 8;                   // uint32 words of one k256 step
constexpr int ROW_BYTES = KW * 4;       // bytes of one row in a stage
constexpr int N_ACC = WG_ROWS * BN / WG_THREADS;  // s32 accumulators a thread
constexpr int MAX_WARPGROUPS = 4;       // consumer warpgroups a block: 256 query rows
constexpr int MAX_STAGES = 8;           // ring depth the plan may choose
constexpr int MIN_STAGES = 3;           // one in flight, one read, one landing
constexpr int MAX_STAGE_STEPS = 4;      // k256 steps a stage: 128 bytes of a row

enum Measure { COUNTS = 0, IP = 1, HAMMING = 2, JACCARD = 3, COSINE = 4 };

// bytes of one k256 step of a stage
__host__ __device__ constexpr int stage_bytes(int rows_a) { return (rows_a + BN) * ROW_BYTES; }

// Accumulator v of lane `lane` in warp `wl` of its warpgroup holds row
// 16*wl + lane/4 + 8*((v >> 1) & 1) and column 8*(v >> 2) + 2*(lane & 3) + (v & 1)
// of the warpgroup's 64 x 128 tile (PTX ISA, wgmma D fragment).
__device__ __forceinline__ int acc_row(int wl, int lane, int v) {
  return 16 * wl + (lane >> 2) + 8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int lane, int v) {
  return 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's cp.async groups are pending (n < MAX_STAGES)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
  }
}

// VEC bytes from src to shared address dst, or VEC zero bytes when !valid
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? VEC : 0;
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  }
}

// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared-memory descriptor of an operand in wgmma's K-major layout without
// swizzle: core matrices of 8 rows x 16 bytes, 128 contiguous bytes each; the
// two 16-byte halves of a row's k256 step are LBO = 128 bytes apart, 8-row
// groups SBO = 256 bytes apart (stage_offset below).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32);
}

// Byte offset of bytes [byte, byte + 4) of row `row` within a stage.
__device__ __forceinline__ uint32_t stage_offset(int row, int byte) {
  return (row >> 3) * 256 + (byte >> 4) * 128 + (row & 7) * 16 + (byte & 15);
}

// d (64 x 128 s32 fragment) += popcount(A & B) over one k256 step; with
// accumulate == 0 the sum starts from zero instead.
__device__ __forceinline__ void mma_b1(int (&d)[N_ACC], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// An empty definition of every accumulator register. The fence, commit and
// wait instructions name no register, so without it the compiler may move a
// write of the accumulators past wgmma.fence, or a read of them above
// wgmma.wait_group: placed before the fence and after the wait, it pins them.
__device__ __forceinline__ void fence_acc(int (&d)[N_ACC]) {
#pragma unroll
  for (int v = 0; v < N_ACC; ++v) asm volatile("" : "+r"(d[v])::"memory");
}

// ------------------------------------------------------------ mainloop
// Issue the copies of one stage at shared address dst: `ks` k256 steps of
// rows [0, rows_a), query rows q0 + r of A, and rows [rows_a, rows_a + BN),
// corpus rows c0 + r of B, from word k0 on. Step j of the stage is its own
// block of stage_bytes(rows_a) bytes in wgmma's layout. Consecutive threads
// take consecutive 16-byte pieces of a row (VEC = 16), so a warp's copies
// cover whole 128-byte lines at ks = 4. VEC = 16 needs W % 4 == 0 and
// 16-byte aligned bases, so a piece is wholly inside or wholly past the row.
template <int VEC>
__device__ __forceinline__ void load_stage(uint32_t dst, const uint32_t* __restrict__ A, int Q,
                                           const uint32_t* __restrict__ B, int C, int W,
                                           int q0, int rows_a, int c0, int k0, int ks) {
  const int per_row = ks * ROW_BYTES / VEC;
  const int total = (rows_a + BN) * per_row;
  const uint32_t step_bytes = stage_bytes(rows_a);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int row = i / per_row;
    const int byte = (i % per_row) * VEC;  // within the row's ks * 32 bytes
    const int word = k0 + byte / 4;
    const bool is_a = row < rows_a;
    const int g = is_a ? q0 + row : c0 + row - rows_a;
    const bool ok = (is_a ? g < Q : g < C) && word < W;
    const uint32_t* base = is_a ? A : B;
    cp_async<VEC>(dst + (byte / ROW_BYTES) * step_bytes + stage_offset(row, byte % ROW_BYTES),
                  ok ? base + (size_t)g * W + word : base, ok);
  }
}

// Count corpus tiles [t0, t1) against query rows [q0, q0 + rows_a): for each
// tile, every warpgroup's 64 x 128 counts accumulate in registers over
// ceil(W / 8) k256 steps, `ks` steps a stage, then on_tile(c0, acc) runs on
// every thread of the block (it may hold block-wide barriers; it may
// overwrite acc). `ring` holds `stages` stages of ks * stage_bytes(rows_a).
template <int VEC, typename OnTile>
__device__ __forceinline__ void count_tiles(const uint32_t* __restrict__ A, int Q,
                                            const uint32_t* __restrict__ B, int C, int W,
                                            int q0, int rows_a, int t0, int t1,
                                            unsigned char* ring, int stages, int ks,
                                            OnTile&& on_tile) {
  const int nk = (W + KW - 1) / KW;
  const int per_tile = (nk + ks - 1) / ks;  // stages a tile
  const int total = (t1 - t0) * per_tile;
  const int ahead = stages - 2;  // stages loading while one is read and one in flight
  const uint32_t step_bytes = stage_bytes(rows_a);
  const uint32_t bytes = ks * step_bytes;
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t a_off = (threadIdx.x / WG_THREADS) * (WG_ROWS / 8) * 256;
  const uint32_t b_off = (rows_a / 8) * 256;
  int acc[N_ACC];
#pragma unroll
  for (int v = 0; v < N_ACC; ++v) acc[v] = 0;

  auto issue = [&](int it) {
    if (it < total) {
      load_stage<VEC>(ring_addr + (it % stages) * bytes, A, Q, B, C, W, q0, rows_a,
                      (t0 + it / per_tile) * BN, (it % per_tile) * ks * KW, ks);
    }
    cp_async_commit();  // one group per stage, empty past the end
  };
  for (int it = 0; it < ahead; ++it) issue(it);
  for (int it = 0; it < total; ++it) {
    cp_async_wait(ahead - 1);  // this thread's copies of stage `it` have landed
    fence_proxy_async();
    // every copy of stage `it` has landed, and every wgmma of stage it - 2
    // is done, so its slot, (it + ahead) % stages, may be refilled
    __syncthreads();
    issue(it + ahead);
    const uint32_t st = ring_addr + (it % stages) * bytes;
    const int s = it % per_tile;
    const int steps = min(ks, nk - s * ks);
    fence_acc(acc);
    wgmma_fence();
    for (int j = 0; j < steps; ++j) {
      mma_b1(acc, smem_desc(st + j * step_bytes + a_off), smem_desc(st + j * step_bytes + b_off),
             s != 0 || j != 0);
    }
    wgmma_commit();
    if (s == per_tile - 1) {
      wgmma_wait<0>();
      fence_acc(acc);
      on_tile((t0 + it / per_tile) * BN, acc);
    } else {
      wgmma_wait<1>();
    }
  }
  cp_async_wait(0);
}

// The fused estimator epilogue (kernels/popcount_sim.py::_epilogue).
// card(c) = d[c] * inv, where d is the (N + 1)-entry float32 table of
// ln(max(N - c, 0.5)) - ln N the host builds once per N
// (hopper/ref.py::log_ratio_table); counts outside [0, N] clamp to its ends
// as the reference clips. A row's and a column's terms (side) are looked up
// once and shared by every pair they meet, so a pair costs one cached load,
// that of its union, not three logf.
// IP = card_a + card_b - card_u cancels most of its digits, so single
// roundings decide the result to ~1e-5: the multiply-adds below are fused
// (__fmaf_rn) exactly where XLA fuses them in the reference kernel, per
// measure, and every other operation up to that difference rounds on its own
// (--fmad=false). The last step, Jaccard's division and cosine's square
// root, takes the hardware's approximations (__fdividef, rsqrtf: within 2 ulp,
// ~2e-7 relative, after the cancellation): the IEEE forms branch to a slow
// path for every score, and those branches kept the compiler from
// interleaving the scores' table loads.
struct Side {
  float d;     // d[fill]
  float card;  // d[fill] * inv
};

template <int M>
__device__ __forceinline__ Side side(int fill, const float* __restrict__ d, float inv,
                                     int n_bins) {
  if constexpr (M == COUNTS) {
    return {0.0f, 0.0f};  // d is null then
  } else {
    const float v = __ldg(d + min(max(fill, 0), n_bins));
    return {v, v * inv};
  }
}

// n_ab = fill of a + fill of b
template <int M>
__device__ __forceinline__ float epilogue(int count, int n_ab, Side a, Side b,
                                          const float* __restrict__ d, float inv, int n_bins) {
  if constexpr (M == COUNTS) {
    return (float)count;
  } else {
    const float d_u = __ldg(d + min(max(n_ab - count, 0), n_bins));
    const float card_u = d_u * inv;
    if constexpr (M == COSINE) {
      const float ip = fmaxf(__fmaf_rn(-d_u, inv, a.card + b.card), 0.0f);
      return fminf(fmaxf(ip * rsqrtf(fmaxf(a.card * b.card, 1e-18f)), 0.0f), 1.0f);
    }
    const float sum_ab = __fmaf_rn(b.d, inv, a.card);
    if constexpr (M == JACCARD) {
      const float ip = fmaxf(sum_ab - card_u, 0.0f);
      return fminf(fmaxf(__fdividef(ip, fmaxf(card_u, 1e-9f)), 0.0f), 1.0f);
    }
    const float ip = fmaxf(__fmaf_rn(-d_u, inv, sum_ab), 0.0f);
    if constexpr (M == IP) return ip;
    return fmaxf(sum_ab - 2.0f * ip, 0.0f);  // HAMMING
  }
}

inline cudaError_t set_dynamic_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

// Name of a CUDA error code, for the Python side's messages.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
