// BinSketch construction: mapped bin ids -> packed sketch words.
//
// Replaces kernels/sketch_build.py::build_sketch_kernel. The kernel body is
// bitmap_build.cuh's warp-per-row build (its note says what bounds it and
// what the design does about that), instantiated with RangeMap: bit t of a
// row is set iff some id of the row equals t.
//
// bins: (B, P) int32, pad -1; ids outside [0, n_bins) set no bit.
// out:  (B, W) uint32 words, W = ceil(n_bins / 32).
#include "bitmap_build.cuh"
#include "common.cuh"

extern "C" int sketch_build(const void* bins, int B, int P, int n_bins, int W,
                            int rows_per_block, long long smem_bytes, int vec_in, int vec_out,
                            void* out, void* stream) {
  repro::RangeMap map{static_cast<uint32_t>(n_bins)};
  return repro::bitmap_build_launch(bins, B, P, map, W, rows_per_block, smem_bytes, vec_in,
                                    vec_out, out, stream);
}
