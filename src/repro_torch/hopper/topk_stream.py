"""Launch of ``csrc/topk_stream.cu``: streaming score -> top-k, (Q, C) never stored.

Replaces ``kernels/topk_stream.py::sketch_topk_kernel``. Pass one splits the
corpus across blocks (query tile x corpus split); each block keeps a running
top-``k_pad`` per query in shared memory and writes it to a small
``(Q, splits, k_pad)`` buffer of 64-bit keys (order-preserving score bits
above ``~id``). Pass two merges the splits per query and decodes the keys.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .popcount_sim import MAX_GRID_Y, MEASURE_CODES, epilogue_args

__all__ = ["MAX_K_PAD", "launch", "next_pow2", "split_plan"]

TILE_Q = 64  # csrc/common.cuh TQ
TILE_C = 64  # csrc/common.cuh TC
# per-query lists of a 64-query block: 64 * 256 * 8 B = 128 KB of shared memory
MAX_K_PAD = 256
# blocks to aim for on each SM, so the last wave is short
_BLOCKS_PER_SM = 4


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def split_plan(q: int, c: int, sm_count: int) -> Tuple[int, int]:
    """(splits, tiles per split): cut the corpus so that query tiles times
    splits fill the card about ``_BLOCKS_PER_SM`` times over."""
    n_tiles = -(-c // TILE_C)
    q_tiles = -(-q // TILE_Q)
    splits = max(1, min(n_tiles, -(-(_BLOCKS_PER_SM * sm_count) // q_tiles)))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


def launch(a: torch.Tensor, b: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
           valid: Optional[torch.Tensor], n_bins: int, measure: str,
           k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) x (C, W) int32 words -> ((Q, k_pad) float32 scores, (Q, k_pad)
    int32 ids), rows by (score desc, id asc), empty slots -inf / -1."""
    build.require_cuda(a, "sketch_topk")
    if k_pad != next_pow2(k_pad) or not 1 <= k_pad <= MAX_K_PAD:
        raise ValueError(f"sketch_topk: k_pad must be a power of two <= {MAX_K_PAD}, "
                         f"got {k_pad}")
    q, w = a.shape
    c = b.shape[0]
    if -(-q // TILE_Q) > MAX_GRID_Y:
        raise ValueError(f"sketch_topk: {q} query rows exceed the launch grid")
    dev = a.device
    splits, per = split_plan(q, c, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((q, splits, k_pad), dtype=torch.int64, device=dev)
    out_s = torch.empty((q, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_pad), dtype=torch.int32, device=dev)
    table, inv = epilogue_args(n_bins, measure, dev)
    lib = build.library("topk_stream")
    with torch.cuda.device(dev):
        stream = build.stream_handle(a)
        err = lib.sketch_topk_partial(
            a.data_ptr(), b.data_ptr(), na.data_ptr(), nb.data_ptr(),
            None if valid is None else valid.data_ptr(), q, c, w, MEASURE_CODES[measure],
            table, inv, int(n_bins), k_pad, splits, per, partial.data_ptr(), stream)
        build.check(lib, err, "sketch_topk_partial")
        err = lib.sketch_topk_merge(partial.data_ptr(), q, splits, k_pad,
                                    out_s.data_ptr(), out_i.data_ptr(), stream)
    build.check(lib, err, "sketch_topk_merge")
    return out_s, out_i
