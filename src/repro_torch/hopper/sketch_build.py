"""Launch of ``csrc/sketch_build.cu``: mapped bin ids -> packed sketch words.

Replaces ``kernels/sketch_build.py::build_sketch_kernel``. One block a row
builds the row's bitmap in shared memory with ``atomicOr`` and writes it once;
the kernel is bound by bytes (``B*P*4`` read, ``B*W*4`` written).
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["MAX_WORDS", "launch"]

# the row bitmap lives in the default 48 KB of dynamic shared memory
MAX_WORDS = (48 * 1024) // 4


def launch(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bins: (B, P)`` int32 CUDA tensor -> ``(B, ceil(n_bins/32))`` int32 words."""
    build.require_cuda(bins, "build_sketch")
    w = (int(n_bins) + 31) // 32
    if w > MAX_WORDS:
        raise ValueError(f"build_sketch: {n_bins} bins need {w} words; the kernel "
                         f"holds at most {MAX_WORDS} in shared memory")
    bins = bins.contiguous()
    b, p = bins.shape
    out = torch.empty((b, w), dtype=torch.int32, device=bins.device)
    lib = build.library("sketch_build")
    with torch.cuda.device(bins.device):
        err = lib.sketch_build(bins.data_ptr(), b, p, int(n_bins), w, out.data_ptr(),
                               build.stream_handle(bins))
    build.check(lib, err, "sketch_build")
    return out
