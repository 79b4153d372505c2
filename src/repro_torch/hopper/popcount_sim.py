"""Launch of ``csrc/popcount_sim.cu``: AND-popcount scores with the fused epilogue.

Replaces ``kernels/popcount_sim.py::sketch_score_kernel`` (and ``score_kernel``,
its ``counts`` form). The counts are a binary matrix product on the tensor
cores (``wgmma ... m64n128k256.s32.b1.b1.and.popc``, ``csrc/common.cuh``):
persistent blocks of 64 to 256 query rows walk ranges of 128-row corpus
tiles, both operands streamed through shared memory in stages of up to four
k256 steps (8 words each), the word tail zero-filled on the way in. Each
tile's counts go through the float32 estimator epilogue in registers, which
reads each count's log term from ``ref.log_ratio_table``. The tensor cores
are not what bounds it on the card: the copies into shared memory and the
epilogue are (``csrc/common.cuh``).

:func:`launch_plan` is the pure-Python side of the launch, shared with the
top-k kernel: queries per block, stage depth, corpus tiles per block and the
shared-memory bytes, raising ``ValueError`` where nothing fits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import build
from .ref import log_ratio_table

__all__ = ["LaunchPlan", "MAX_K_PAD", "MEASURE_CODES", "SMEM_LIMIT", "epilogue_args",
           "launch", "launch_plan", "mma_b1_loop", "next_pow2", "sm_count", "smem_bytes", "vec16"]

# must match the Measure enum of csrc/common.cuh
MEASURE_CODES = {"counts": 0, "ip": 1, "hamming": 2, "jaccard": 3, "cosine": 4}
# shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
# csrc/common.cuh: wgmma's M (query rows a warpgroup), N (corpus rows a tile),
# words of one k256 step, warpgroups a block, and the ring depths a plan may
# choose
WG_ROWS, TILE_ROWS, STEP_WORDS = 64, 128, 8
MAX_WARPGROUPS = 4
# csrc/topk_stream.cu TOPK_WARPGROUPS: the top-k kernel's filter state needs
# the registers of a two-warpgroup block
TOPK_WARPGROUPS = 2
MIN_STAGES, MAX_STAGES = 3, 8
# k256 steps a stage at most: 128 bytes of each row, whole lines
MAX_STAGE_STEPS = 4
# csrc/popcount_sim.cu: a warp stages 16 rows of 33 floats for its stores
_OUT_WARP_BYTES = 16 * 33 * 4
# csrc/topk_stream.cu: candidate slots a query row has in one round
CAND_SLOTS = 32
# largest k_pad of the top-k kernel: 64 lists of 256 keys take 128 KB
MAX_K_PAD = 256
# query tiles run along the grid's y axis, which CUDA caps here
MAX_GRID_Y = 65535


def smem_bytes(warpgroups: int, stages: int, k_pad: int = 0, stage_steps: int = 1) -> int:
    """Shared-memory bytes of a block: the ring of ``stages`` stages of
    ``stage_steps`` k256 steps of ``64 * warpgroups`` query rows and 128
    corpus rows, then the score kernel's store staging (``k_pad == 0``) or
    the top-k kernel's lists, candidate buffers and counts. Mirrors
    ``score_smem_bytes`` and ``topk_smem_bytes`` of the CUDA sources, which
    refuse any other value."""
    rows = warpgroups * WG_ROWS
    ring = stages * stage_steps * (rows + TILE_ROWS) * STEP_WORDS * 4
    if k_pad == 0:
        return ring + warpgroups * 4 * _OUT_WARP_BYTES
    return ring + rows * k_pad * 8 + rows * CAND_SLOTS * 8 + rows * 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut into blocks: ``q_tiles`` query tiles of
    ``64 * warpgroups`` rows times ``splits`` corpus ranges of
    ``tiles_per_split`` 128-row tiles (the last range may be shorter); block
    (x, y) takes query tile y and tiles [x * tiles_per_split, ...)."""

    warpgroups: int
    stages: int
    stage_steps: int
    smem_bytes: int
    q_tiles: int
    splits: int
    tiles_per_split: int
    n_tiles: int


def launch_plan(q: int, c: int, w: int, k_pad: int, sm_count: int) -> LaunchPlan:
    """The launch of a (Q, W) x (C, W) call: the score kernel for ``k_pad ==
    0``, the top-k kernel's first pass otherwise. The most warpgroups (64
    query rows each, up to 4 for the score kernel and 2 for top-k) that the
    queries need, then the deepest stages (k256 steps, up to 4 and no more
    than the ceil(W / 8) a tile has) whose ring leaves room for
    ``MIN_STAGES`` of them beside the lists; the most stages up to
    ``MAX_STAGES`` that fit; then enough corpus splits for one block on each
    of ``sm_count`` SMs. Raises ``ValueError`` for a shape no plan fits."""
    if q < 1 or c < 1 or w < 1:
        raise ValueError(f"launch_plan: need Q, C, W >= 1, got {(q, c, w)}")
    if k_pad and (k_pad & (k_pad - 1) or not 1 <= k_pad <= MAX_K_PAD):
        raise ValueError(f"launch_plan: k_pad must be a power of two <= {MAX_K_PAD}, "
                         f"got {k_pad}")
    need = min(TOPK_WARPGROUPS if k_pad else MAX_WARPGROUPS, next_pow2(-(-q // WG_ROWS)))
    deepest = min(MAX_STAGE_STEPS, -(-w // STEP_WORDS))
    fits = ((wgs, steps, min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(wgs, 0, k_pad))
                             // (steps * (wgs * WG_ROWS + TILE_ROWS) * STEP_WORDS * 4)))
            for wgs in (4, 2, 1) if wgs <= need for steps in range(deepest, 0, -1))
    for wgs, steps, stages in fits:
        if stages >= MIN_STAGES:
            break
    else:
        raise ValueError(f"launch_plan: k_pad={k_pad} leaves no room for the ring")
    q_tiles = -(-q // (wgs * WG_ROWS))
    if q_tiles > MAX_GRID_Y:
        raise ValueError(f"launch_plan: {q} query rows exceed the launch grid")
    n_tiles = -(-c // TILE_ROWS)
    splits = max(1, min(n_tiles, -(-sm_count // q_tiles)))
    per = -(-n_tiles // splits)
    return LaunchPlan(warpgroups=wgs, stages=stages, stage_steps=steps,
                      smem_bytes=smem_bytes(wgs, stages, k_pad, steps), q_tiles=q_tiles,
                      splits=-(-n_tiles // per), tiles_per_split=per, n_tiles=n_tiles)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


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


def vec16(a: torch.Tensor, b: torch.Tensor) -> int:
    """1 where the copies into shared memory may move 16 bytes at a time:
    W a multiple of 4 words and both bases 16-byte aligned; else 4 bytes."""
    return int(a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(a: torch.Tensor, b: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
           n_bins: int, measure: str) -> torch.Tensor:
    """(Q, W) x (C, W) int32 words, (Q,), (C,) int32 fills -> (Q, C) float32."""
    build.require_cuda(a, "sketch_score")
    q, w = a.shape
    c = b.shape[0]
    plan = launch_plan(q, c, w, 0, sm_count(a.device))
    out = torch.empty((q, c), dtype=torch.float32, device=a.device)
    table, inv = epilogue_args(n_bins, measure, a.device)
    lib = build.library("popcount_sim")
    with torch.cuda.device(a.device):
        err = lib.sketch_score(a.data_ptr(), b.data_ptr(), na.data_ptr(), nb.data_ptr(),
                               q, c, w, MEASURE_CODES[measure], table, inv, int(n_bins),
                               out.data_ptr(), plan.warpgroups, plan.stages, plan.stage_steps,
                               plan.splits, plan.tiles_per_split, plan.smem_bytes, vec16(a, b),
                               build.stream_handle(a))
    build.check(lib, err, "sketch_score")
    return out


def mma_b1_loop(out: torch.Tensor, iters: int) -> int:
    """Run ``iters`` b1 wgmma (m64n128k256, the tile's instruction) per
    warpgroup on operands resident in shared memory, four warpgroups a
    block, one block per 512 ints of ``out`` (int32 on the card; each thread
    writes its sum there). Returns the bit-AND-popcount multiply-adds it
    runs. For timing the instruction's rate; no kernel of the path calls it."""
    build.require_cuda(out, "mma_b1_loop")
    blocks = out.numel() // (MAX_WARPGROUPS * 128)
    lib = build.library("popcount_sim")
    with torch.cuda.device(out.device):
        err = lib.mma_b1_loop(blocks, int(iters), out.data_ptr(), build.stream_handle(out))
    build.check(lib, err, "mma_b1_loop")
    return blocks * MAX_WARPGROUPS * int(iters) * WG_ROWS * TILE_ROWS * 32 * STEP_WORDS
