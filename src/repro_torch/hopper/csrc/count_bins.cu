// Counting BinSketch construction: mapped bin ids -> dense per-bin occupancy.
//
// Replaces kernels/count_update.py::count_bins_kernel. The TPU kernel compares
// every bin id of a row against every target bin of a tile and sum-reduces,
// because a TPU has no scatter. Here each block owns one (row, bin tile),
// builds the tile's histogram in shared memory with atomicAdd, and writes it
// out once, coalesced.
//
// bins: (B, P) int32, pad -1; ids outside [0, n_bins) never count.
// out:  (B, n_bins) int32, out[b, t] = #{p : bins[b, p] == t}.
//
// Grid (B, ceil(n_bins / tile)); tile * 4 bytes of dynamic shared memory
// (the wrapper keeps it within the 48 KB default). A row wider than one tile
// is re-read once per tile.
//
// Bound: bytes. The dense output dominates: B*n_bins*4 bytes written against
// B*P*4 read; the shared-memory atomics are cheap next to that.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void count_bins_kernel(const int* __restrict__ bins, int P, int n_bins,
                                  int tile, int* __restrict__ out) {
  extern __shared__ int hist[];
  const size_t row = blockIdx.x;
  const int lo = blockIdx.y * tile;
  const int len = min(tile, n_bins - lo);
  for (int t = threadIdx.x; t < len; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int* r = bins + row * (size_t)P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int t = r[p] - lo;  // pads (-1) and ids below the tile go negative
    if (t >= 0 && t < len) atomicAdd(&hist[t], 1);
  }
  __syncthreads();
  int* o = out + row * (size_t)n_bins + lo;
  for (int t = threadIdx.x; t < len; t += blockDim.x) o[t] = hist[t];
}

}  // namespace

extern "C" int count_bins(const void* bins, int B, int P, int n_bins, int tile,
                          void* out, void* stream) {
  if (B > 0 && n_bins > 0) {
    const dim3 grid(B, (n_bins + tile - 1) / tile);
    count_bins_kernel<<<grid, kThreads, tile * sizeof(int),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bins), P, n_bins, tile, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
