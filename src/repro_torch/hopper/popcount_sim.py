"""Launch of ``csrc/popcount_sim.cu``: AND-popcount scores with the fused epilogue.

Replaces ``kernels/popcount_sim.py::sketch_score_kernel`` (and ``score_kernel``,
its ``counts`` form). 64 x 64 output tiles, counts in registers from word slabs
staged in shared memory, then the float32 estimator epilogue, which reads
each count's log term from ``ref.log_ratio_table``; bound by
the ``Q*C*W`` integer AND/POPC/ADD work.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build
from .ref import log_ratio_table

__all__ = ["MAX_GRID_Y", "MEASURE_CODES", "epilogue_args", "launch"]

# query tiles of 64 rows run along the grid's y axis, which CUDA caps here
MAX_GRID_Y = 65535
# must match the Measure enum of csrc/common.cuh
MEASURE_CODES = {"counts": 0, "ip": 1, "hamming": 2, "jaccard": 3, "cosine": 4}


@functools.lru_cache(maxsize=16)
def _device_table(n_bins: int, device: torch.device) -> Tuple[torch.Tensor, float]:
    d, inv = log_ratio_table(n_bins)
    return torch.from_numpy(d.copy()).to(device), inv


def epilogue_args(n_bins: int, measure: str, device: torch.device) -> Tuple[Optional[int], float]:
    """(pointer to the (N + 1,) log table on ``device``, 1/log1p(-1/N)) for
    the C side; the table is uploaded once per (N, device). The counts form
    reads neither."""
    if measure == "counts":
        return None, 0.0
    table, inv = _device_table(int(n_bins), device)
    return table.data_ptr(), inv


def launch(a: torch.Tensor, b: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
           n_bins: int, measure: str) -> torch.Tensor:
    """(Q, W) x (C, W) int32 words, (Q,), (C,) int32 fills -> (Q, C) float32."""
    build.require_cuda(a, "sketch_score")
    q, w = a.shape
    c = b.shape[0]
    if -(-q // 64) > MAX_GRID_Y:
        raise ValueError(f"sketch_score: {q} query rows exceed the launch grid")
    out = torch.empty((q, c), dtype=torch.float32, device=a.device)
    table, inv = epilogue_args(n_bins, measure, a.device)
    lib = build.library("popcount_sim")
    with torch.cuda.device(a.device):
        err = lib.sketch_score(a.data_ptr(), b.data_ptr(), na.data_ptr(), nb.data_ptr(),
                               q, c, w, MEASURE_CODES[measure], table, inv, int(n_bins),
                               out.data_ptr(), build.stream_handle(a))
    build.check(lib, err, "sketch_score")
    return out
