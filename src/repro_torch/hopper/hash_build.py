"""Launch of ``csrc/hash_build.cu``: raw indices -> packed sketch words in hash mode.

Replaces ``kernels/hash_build.py::hash_build_kernel``. The kernel body is
``sketch_build``'s warp-per-row bitmap build (``csrc/bitmap_build.cuh``), each
index hashed in registers with ``((a*i + b) mod 2^32) mod N`` in ``uint32_t``,
the modulus an exact 64-bit reciprocal (:func:`reciprocal`) computed here;
bound by bytes (``B*P*4`` read, ``B*W*4`` written). A call is one kernel
launch: the coefficients stay on the card and the kernel reads them there.
"""

from __future__ import annotations

import torch

from .sketch_build import launch_bitmap

__all__ = ["launch", "reciprocal"]

_U64 = (1 << 64) - 1


def reciprocal(n_bins: int) -> int:
    """``floor((2^64 - 1) / N) + 1 mod 2^64``: the kernel's ``h mod N`` is
    ``umulhi64(reciprocal(N) * h mod 2^64, N)``, exact for every 32-bit h
    and ``1 <= N < 2^32`` (N = 1 gives 0, so bin 0)."""
    n = int(n_bins)
    if not 1 <= n < 1 << 32:
        raise ValueError(f"hash_build_sketch: need 1 <= N < 2^32, got {n}")
    return (_U64 // n + 1) & _U64


def launch(idx: torch.Tensor, coeffs: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``idx: (B, P)`` int32 CUDA tensor and ``coeffs: (2,)`` integer tensor of
    uint32 values (int64, or int32 holding the bits) -> ``(B, ceil(n_bins/32))``
    int32 words."""
    # a no-op for the mapping's int64 on the card; an int32 of uint32 bits
    # widens with its low 32 bits kept, which is all the kernel reads
    ab = coeffs.to(device=idx.device, dtype=torch.int64).contiguous()
    return launch_bitmap("hash_build", idx, n_bins, (ab.data_ptr(), int(n_bins),
                                                    reciprocal(n_bins)), "hash_build_sketch")
