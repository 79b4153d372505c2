"""Launch of ``csrc/count_bins.cu``: mapped bin ids -> dense per-bin occupancy.

Replaces ``kernels/count_update.py::count_bins_kernel``. One block per (row,
bin tile) builds the tile's histogram in shared memory with ``atomicAdd`` and
writes it once; the kernel is bound by the dense ``B*N*4``-byte output.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["TILE_BINS", "launch"]

# bins a block counts: its histogram fills the default 48 KB of dynamic
# shared memory; wider rows take several tiles along the grid's y axis
TILE_BINS = (48 * 1024) // 4


def launch(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bins: (B, P)`` int32 CUDA tensor -> ``(B, n_bins)`` int32 counts."""
    build.require_cuda(bins, "count_bins")
    bins = bins.contiguous()
    b, p = bins.shape
    out = torch.empty((b, int(n_bins)), dtype=torch.int32, device=bins.device)
    lib = build.library("count_bins")
    with torch.cuda.device(bins.device):
        err = lib.count_bins(bins.data_ptr(), b, p, int(n_bins),
                             min(TILE_BINS, int(n_bins)), out.data_ptr(),
                             build.stream_handle(bins))
    build.check(lib, err, "count_bins")
    return out
