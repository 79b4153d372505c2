// Hash-mode BinSketch construction: raw feature indices -> packed sketch
// words, the multiply-shift map computed in the kernel.
//
// Replaces kernels/hash_build.py::hash_build_kernel. For huge d there is no
// Psi table: an index i maps to bin ((a*i + b) mod 2^32) mod N. Mapping
// first and building second costs one more pass over the (B, P) bin ids in
// device memory; here the raw indices are read once and hashed in
// registers. The kernel body is bitmap_build.cuh's warp-per-row build (its
// note says what bounds it and what the design does about that),
// instantiated with HashMap: the hash in uint32_t, the modulus by the true
// N as an exact 64-bit reciprocal, so bits >= N are never set. Negative
// indices are pads and set no bit.
//
// idx: (B, P) int32.  coeffs: (2,) int64 (a, b), their low 32 bits read on
// the device.  recip: floor((2^64 - 1) / N) + 1 mod 2^64.
// out: (B, W) uint32, W = ceil(N / 32).
#include "bitmap_build.cuh"
#include "common.cuh"

extern "C" int hash_build(const void* idx, int B, int P, const void* coeffs, int n_bins,
                          unsigned long long recip, int W, int rows_per_block,
                          long long smem_bytes, int vec_in, int vec_out, void* out,
                          void* stream) {
  repro::HashMap map{static_cast<const long long*>(coeffs), static_cast<uint32_t>(n_bins),
                     recip, 0u, 0u};
  return repro::bitmap_build_launch(idx, B, P, map, W, rows_per_block, smem_bytes, vec_in,
                                    vec_out, out, stream);
}
