"""Launch of ``csrc/topk_stream.cu``: streaming score -> top-k, (Q, C) never stored.

Replaces ``kernels/topk_stream.py::sketch_topk_kernel``. Pass one counts on
the tensor cores with the score kernel's mainloop (persistent blocks, each a
query tile of up to 128 rows against a range of corpus tiles,
:func:`.popcount_sim.launch_plan`), scores each tile in registers and
filters it there against each row's current k_pad-th key; the survivors
enter a running top-``k_pad`` per query in shared memory, written out to a
small ``(Q, splits, k_pad)`` buffer of 64-bit keys (order-preserving score
bits above ``~id``). Pass two merges the splits per query and decodes the
keys.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .popcount_sim import (MAX_K_PAD, MEASURE_CODES, epilogue_args, launch_plan, next_pow2,
                           sm_count, vec16)

__all__ = ["MAX_K_PAD", "launch", "next_pow2"]


def launch(a: torch.Tensor, b: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
           valid: Optional[torch.Tensor], n_bins: int, measure: str,
           k_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) x (C, W) int32 words -> ((Q, k_pad) float32 scores, (Q, k_pad)
    int32 ids), rows by (score desc, id asc), empty slots -inf / -1."""
    build.require_cuda(a, "sketch_topk")
    q, w = a.shape
    c = b.shape[0]
    dev = a.device
    plan = launch_plan(q, c, w, k_pad, sm_count(dev))
    partial = torch.empty((q, plan.splits, k_pad), dtype=torch.int64, device=dev)
    out_s = torch.empty((q, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_pad), dtype=torch.int32, device=dev)
    table, inv = epilogue_args(n_bins, measure, dev)
    lib = build.library("topk_stream")
    with torch.cuda.device(dev):
        stream = build.stream_handle(a)
        err = lib.sketch_topk_partial(
            a.data_ptr(), b.data_ptr(), na.data_ptr(), nb.data_ptr(),
            None if valid is None else valid.data_ptr(), q, c, w, MEASURE_CODES[measure],
            table, inv, int(n_bins), k_pad, plan.warpgroups, plan.stages, plan.stage_steps,
            plan.splits, plan.tiles_per_split, plan.smem_bytes, vec16(a, b), partial.data_ptr(),
            stream)
        build.check(lib, err, "sketch_topk_partial")
        err = lib.sketch_topk_merge(partial.data_ptr(), q, plan.splits, k_pad,
                                    out_s.data_ptr(), out_i.data_ptr(), stream)
    build.check(lib, err, "sketch_topk_merge")
    return out_s, out_i
