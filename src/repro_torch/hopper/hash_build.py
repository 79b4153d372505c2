"""Launch of ``csrc/hash_build.cu``: raw indices -> packed sketch words in hash mode.

Replaces ``kernels/hash_build.py::hash_build_kernel``. One block a row hashes
its indices with ``((a*i + b) mod 2^32) mod N`` in ``uint32_t`` and builds the
row's bitmap in shared memory with ``atomicOr``, as ``sketch_build`` does; the
kernel is bound by bytes (``B*P*4`` read, ``B*W*4`` written).
"""

from __future__ import annotations

import torch

from ..core import packed as pk
from . import build
from .sketch_build import MAX_WORDS

__all__ = ["launch"]


def launch(idx: torch.Tensor, coeffs: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``idx: (B, P)`` int32 CUDA tensor and ``coeffs: (2,)`` integer tensor of
    uint32 values -> ``(B, ceil(n_bins/32))`` int32 words."""
    build.require_cuda(idx, "hash_build_sketch")
    w = (int(n_bins) + 31) // 32
    if w > MAX_WORDS:
        raise ValueError(f"hash_build_sketch: {n_bins} bins need {w} words; the kernel "
                         f"holds at most {MAX_WORDS} in shared memory")
    idx = idx.contiguous()
    b, p = idx.shape
    # (a, b) as int32 storage with the uint32 bits, on the card: no host read
    ab = pk._to_int32_bits(coeffs.to(device=idx.device, dtype=torch.int64) & pk._U32)
    out = torch.empty((b, w), dtype=torch.int32, device=idx.device)
    lib = build.library("hash_build")
    with torch.cuda.device(idx.device):
        err = lib.hash_build(idx.data_ptr(), b, p, ab.data_ptr(), int(n_bins), w,
                             out.data_ptr(), build.stream_handle(idx))
    build.check(lib, err, "hash_build")
    return out
