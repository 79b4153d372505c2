"""Launch of ``csrc/rebucket.cu``: packed rows folded from N to N' <= N bins.

Replaces ``kernels/rebucket.py::rebucket_kernel``. One thread per (row,
output word) ORs a funnel shift of two source words per chunk of N' source
bits; at the serving shapes (a query chunk, once per distilled width) it is
bound by launch latency.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["launch"]


def launch(packed: torch.Tensor, n_bins: int, n_bins_new: int) -> torch.Tensor:
    """``packed: (B, ceil(N/32))`` int32 CUDA tensor -> ``(B, ceil(N'/32))``."""
    build.require_cuda(packed, "rebucket")
    packed = packed.contiguous()
    b, w = packed.shape
    w_new = (int(n_bins_new) + 31) // 32
    out = torch.empty((b, w_new), dtype=torch.int32, device=packed.device)
    lib = build.library("rebucket")
    with torch.cuda.device(packed.device):
        err = lib.rebucket(packed.data_ptr(), b, w, int(n_bins), int(n_bins_new), w_new,
                           out.data_ptr(), build.stream_handle(packed))
    build.check(lib, err, "rebucket")
    return out
