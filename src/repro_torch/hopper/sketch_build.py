"""Launch of ``csrc/sketch_build.cu``: mapped bin ids -> packed sketch words.

Replaces ``kernels/sketch_build.py::build_sketch_kernel``. The kernel body,
shared with ``hash_build``, is ``csrc/bitmap_build.cuh``: one warp a row
builds the row's bitmap in its own slice of shared memory with ``atomicOr``
from 16-byte loads all in flight at once, and writes it once; it is bound by
bytes (``B*P*4`` read, ``B*W*4`` written).

:func:`launch_plan` is the pure-Python side of the launch, shared by both
builds: rows a block, shared bytes and the width of the loads and stores.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from ..core import packed as pk
from . import build, popcount_sim

__all__ = ["BuildPlan", "MAX_ROWS_PER_BLOCK", "MAX_WORDS", "SMEM_LIMIT", "launch",
           "launch_bitmap", "launch_plan", "slice_words"]

# csrc/bitmap_build.cuh: the default dynamic shared memory (no opt-in), and
# rows (warps) a block at most
SMEM_LIMIT = 48 * 1024
MAX_ROWS_PER_BLOCK = 8
# the widest row: one warp's slice fills the default 48 KB
MAX_WORDS = SMEM_LIMIT // 4


def slice_words(w: int) -> int:
    """Words of one warp's slice of shared memory: W in whole 16-byte groups."""
    return -(-w // 4) * 4


@dataclasses.dataclass(frozen=True)
class BuildPlan:
    """How one build is cut into blocks: ``blocks`` blocks of
    ``rows_per_block`` warps, warp ``j`` of block ``x`` taking row ``x *
    rows_per_block + j`` (rows past B exit); ``vec_in`` / ``vec_out`` are 1
    where the loads / stores move 16 bytes, else 0 (4 bytes)."""

    rows_per_block: int
    blocks: int
    smem_bytes: int
    vec_in: int
    vec_out: int


def launch_plan(b: int, w: int, sms: int, ids_ptr: int, out_ptr: int) -> BuildPlan:
    """Plan of a ``(b, P)`` build into ``(b, w)`` words on a card of ``sms``
    SMs: as many rows a block as fit the default shared memory, up to 8, but
    no more than keep a block on every SM (a 256-row query batch takes one
    row a block). 16-byte loads where the ids' base is 16-byte aligned;
    16-byte stores where W % 4 == 0 and the output's base is aligned.
    Raises ``ValueError`` for ``b < 1`` or W outside ``[1, MAX_WORDS]``."""
    return _plan(b, w, sms, ids_ptr % 16 == 0, w % 4 == 0 and out_ptr % 16 == 0)


@functools.lru_cache(maxsize=256)  # a path launches a few shapes, many times
def _plan(b: int, w: int, sms: int, vec_in: bool, vec_out: bool) -> BuildPlan:
    if b < 1 or not 1 <= w <= MAX_WORDS:
        raise ValueError(f"bitmap build: need B >= 1 and 1 <= W <= {MAX_WORDS}, got B={b}, W={w}")
    sw = slice_words(w)
    rows = max(1, min(MAX_ROWS_PER_BLOCK, SMEM_LIMIT // (4 * sw), b // max(sms, 1)))
    return BuildPlan(rows_per_block=rows, blocks=-(-b // rows), smem_bytes=rows * sw * 4,
                     vec_in=int(vec_in), vec_out=int(vec_out))


def launch_bitmap(name: str, ids: torch.Tensor, n_bins: int, map_args: Sequence,
                  what: str) -> torch.Tensor:
    """Run library ``name``'s entry point of the same name, ``fn(ids, B, P,
    *map_args, W, rows_per_block, smem_bytes, vec_in, vec_out, out,
    stream)``, on ``(B, P)`` int32 CUDA ids; returns ``(B, ceil(N/32))``
    int32 words."""
    build.require_cuda(ids, what)
    w = pk.num_words(int(n_bins))
    if w > MAX_WORDS:
        raise ValueError(f"{what}: {n_bins} bins need {w} words; the kernel "
                         f"holds at most {MAX_WORDS} in shared memory")
    ids = ids.contiguous()
    b, p = ids.shape
    out = torch.empty((b, w), dtype=torch.int32, device=ids.device)
    plan = launch_plan(b, w, popcount_sim.sm_count(ids.device), ids.data_ptr(), out.data_ptr())
    lib = build.library(name)
    with torch.cuda.device(ids.device):
        err = getattr(lib, name)(ids.data_ptr(), b, p, *map_args, w, plan.rows_per_block,
                                 plan.smem_bytes, plan.vec_in, plan.vec_out, out.data_ptr(),
                                 build.stream_handle(ids))
    build.check(lib, err, name)
    return out


def launch(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bins: (B, P)`` int32 CUDA tensor -> ``(B, ceil(n_bins/32))`` int32 words."""
    return launch_bitmap("sketch_build", bins, n_bins, (int(n_bins),), "build_sketch")
