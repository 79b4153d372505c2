// One kernel body for the two bitmap builds: padded (B, P) int32 ids in,
// packed (B, W) uint32 words out, bit t of a row set iff some id of the row
// maps to bin t. sketch_build.cu instantiates it with RangeMap (ids already
// mapped: a range check), hash_build.cu with HashMap (raw indices: the
// multiply-shift hash). Both replace TPU kernels that compare every id
// against every target bin and OR-reduce, because a TPU has no scatter.
//
// Bound: bytes, B*P*4 read and B*W*4 written. What keeps a kernel like this
// from the memory rate is too few bytes in flight: about 25 KB an SM hide
// the latency of device memory at 3.35 TB/s. So:
//
// * One warp a row, up to BITMAP_MAX_ROWS rows a block, and no block
//   barrier: each warp owns a W-word slice of shared memory (W rounded up
//   to whole 16-byte groups), zeroes it with 16-byte stores and meets its
//   own lanes only, at __syncwarp().
// * Each lane issues all its loads of a chunk of the row before its first
//   atomicOr: BITMAP_LOADS 16-byte loads (all of a row of P <= 1020 ids),
//   non-allocating in L1, so a warp has up to 4 KB in flight. Where the
//   base is 16-byte aligned (vec_in) the loads cover the aligned span
//   around the row [row*P, row*P + P); positions outside the row are
//   masked, so a row that starts mid-group costs at most 24 bytes more.
//   The last row's last group, where it would run past B*P, and every
//   group of a base that is not 16-byte aligned, is read with 4-byte loads
//   of the row's own positions only: nothing outside the tensor is read.
// * The scatter is a shared atomicOr into the warp's slice; pads, and ids
//   the map refuses, set nothing.
// * After __syncwarp() the row's words go out as 16-byte streaming stores
//   where W % 4 == 0 (vec_out), else as 4-byte stores.
//
// The launch plan (rows a block, shared bytes, vec_in, vec_out) is pure
// Python, hopper/sketch_build.py::launch_plan; bitmap_build_launch refuses
// any plan that disagrees with this file.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int BITMAP_MAX_ROWS = 8;            // rows (warps) a block
constexpr int BITMAP_LOADS = 8;               // 16-byte groups a lane holds in flight
constexpr int BITMAP_SMEM_LIMIT = 48 * 1024;  // dynamic shared memory without opt-in

// words of one warp's slice: W rounded up to whole 16-byte groups
__host__ __device__ inline int bitmap_slice_words(int W) { return (W + 3) & ~3; }

inline size_t bitmap_smem_bytes(int rows, int W) {
  return static_cast<size_t>(rows) * bitmap_slice_words(W) * sizeof(uint32_t);
}

// Ids already mapped to bins: bit t for 0 <= t < N; pads (-1), other
// negative ids and ids >= N set nothing.
struct RangeMap {
  uint32_t n_bins;
  __device__ void load() {}
  __device__ bool operator()(int id, uint32_t& bin) const {
    bin = static_cast<uint32_t>(id);
    return bin < n_bins;
  }
};

// Raw indices: i >= 0 maps to ((a*i + b) mod 2^32) mod N; negative indices
// are pads. The hash is computed in uint32_t, where it wraps mod 2^32 as
// the reference specifies. The modulus by a run-time N is an exact 64-bit
// reciprocal (Lemire's fastmod): with recip = floor((2^64 - 1) / N) + 1 mod
// 2^64, computed on the host, h mod N = umulhi64(recip * h mod 2^64, N) for
// every 32-bit h and 1 <= N < 2^32 (N = 1 gives recip 0 and bin 0).
// (a, b) are the low 32 bits of an int64 pair read on the device, so the
// caller never waits for them.
struct HashMap {
  const long long* coeffs;
  uint32_t n_bins;
  unsigned long long recip;
  uint32_t a, b;
  __device__ void load() {
    a = static_cast<uint32_t>(__ldg(coeffs));
    b = static_cast<uint32_t>(__ldg(coeffs + 1));
  }
  __device__ bool operator()(int id, uint32_t& bin) const {
    const uint32_t h = a * static_cast<uint32_t>(id) + b;
    bin = static_cast<uint32_t>(__umul64hi(recip * h, n_bins));
    return id >= 0;
  }
};

__device__ __forceinline__ int4 ld_stream16(const int* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_stream4(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

template <class Map>
__device__ __forceinline__ void scatter(uint32_t* slice, const Map& map, int id) {
  uint32_t bin;
  if (map(id, bin)) atomicOr(&slice[bin >> 5], 1u << (bin & 31u));
}

// Positions are counted from the row's first id, r in [0, P); group g of a
// warp covers r = 4g - head .. 4g - head + 3, where head is how far the row
// starts past the 16-byte boundary below it (0 for 4-byte loads), so one
// unsigned compare, (unsigned)r < P, masks both the head and the tail.
template <class Map>
__global__ void __launch_bounds__(BITMAP_MAX_ROWS * 32)
    bitmap_build_kernel(const int* __restrict__ ids, int B, int P, Map map, int W, int vec_in,
                        int vec_out, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t bitmap_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // warp-uniform, and no block barrier follows
  const int sw = bitmap_slice_words(W);
  uint32_t* slice = bitmap_smem + static_cast<size_t>(warp) * sw;
  uint4* slice4 = reinterpret_cast<uint4*>(slice);
  for (int g = lane; g < sw / 4; g += 32) slice4[g] = make_uint4(0u, 0u, 0u, 0u);
  map.load();
  __syncwarp();

  const size_t s = static_cast<size_t>(row) * P;
  const int head = vec_in ? static_cast<int>(s & 3) : 0;
  const int* base = ids + (s - head);  // 16-byte aligned where vec_in
  const int groups = (P + head + 3) >> 2;
  // groups read 16 bytes at a time: those that end inside the buffer
  const size_t room = (static_cast<size_t>(B) * P - (s - head)) >> 2;
  const int full = !vec_in ? 0 : room < static_cast<size_t>(groups) ? static_cast<int>(room)
                                                                    : groups;
  const unsigned p = static_cast<unsigned>(P);
  for (int g0 = 0; g0 < groups; g0 += 32 * BITMAP_LOADS) {
    int4 v[BITMAP_LOADS];
#pragma unroll
    for (int k = 0; k < BITMAP_LOADS; ++k) {
      const int g = g0 + k * 32 + lane;
      const int r = 4 * g - head;
      if (g < full) {
        v[k] = ld_stream16(base + 4 * g);
      } else {  // 4-byte loads of the row's own positions only
        v[k].x = static_cast<unsigned>(r) < p ? ld_stream4(base + 4 * g) : -1;
        v[k].y = static_cast<unsigned>(r + 1) < p ? ld_stream4(base + 4 * g + 1) : -1;
        v[k].z = static_cast<unsigned>(r + 2) < p ? ld_stream4(base + 4 * g + 2) : -1;
        v[k].w = static_cast<unsigned>(r + 3) < p ? ld_stream4(base + 4 * g + 3) : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < BITMAP_LOADS; ++k) {
      const int r = 4 * (g0 + k * 32 + lane) - head;
      if (static_cast<unsigned>(r) < p) scatter(slice, map, v[k].x);
      if (static_cast<unsigned>(r + 1) < p) scatter(slice, map, v[k].y);
      if (static_cast<unsigned>(r + 2) < p) scatter(slice, map, v[k].z);
      if (static_cast<unsigned>(r + 3) < p) scatter(slice, map, v[k].w);
    }
  }
  __syncwarp();

  uint32_t* o = out + static_cast<size_t>(row) * W;
  if (vec_out) {
    for (int g = lane; g < W / 4; g += 32) __stcs(reinterpret_cast<uint4*>(o) + g, slice4[g]);
  } else {
    for (int w = lane; w < W; w += 32) o[w] = slice[w];
  }
}

// Launch of one build on the caller's stream; returns cudaGetLastError(),
// or cudaErrorInvalidValue where the plan disagrees with this file.
template <class Map>
int bitmap_build_launch(const void* ids, int B, int P, Map map, int W, int rows_per_block,
                        long long smem_bytes, int vec_in, int vec_out, void* out,
                        void* stream) {
  if (rows_per_block < 1 || rows_per_block > BITMAP_MAX_ROWS || W < 1 ||
      static_cast<size_t>(smem_bytes) != bitmap_smem_bytes(rows_per_block, W) ||
      smem_bytes > BITMAP_SMEM_LIMIT ||
      (vec_in && reinterpret_cast<uintptr_t>(ids) % 16 != 0) ||
      (vec_out && (W % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int blocks = (B + rows_per_block - 1) / rows_per_block;
    bitmap_build_kernel<Map><<<blocks, rows_per_block * 32, static_cast<size_t>(smem_bytes),
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), B, P, map, W, vec_in, vec_out,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
