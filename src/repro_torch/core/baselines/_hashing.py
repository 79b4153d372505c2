"""What the multiply-shift baselines share: seeded coefficient draws, and the
walk over (rows, functions) blocks that keeps their hash lanes bounded.

A sketch of B rows of P elements under k functions touches B·P·k lanes (at
16,384 x 870 x 5859 that is 83.5 billion); the reference maps over the k
functions to stay at O(B·P). Here each block's lanes form one int64
temporary of at most :data:`LANES` elements, so the device runs a few large
elementwise passes per block instead of k small ones.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

U32 = 0xFFFFFFFF
INF = U32  # the empty-bin value of the min-hash sketches (uint32 max)
LANES = 1 << 26  # int64 elements of one (rows, P, functions) block: 512 MiB


def generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def draw_u32(shape, gen: torch.Generator) -> torch.Tensor:
    """Uniform uint32 values as int64 ``shape``, drawn on the CPU."""
    return torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64)


def odd_pairs(k: int, gen: torch.Generator) -> torch.Tensor:
    """(2, k) int64 multiply-shift coefficients ``(a|1, b)``, on the CPU."""
    c = draw_u32((2, int(k)), gen)
    c[0] |= 1
    return c


def blocks(bsz: int, p: int, k: int) -> Iterator[Tuple[slice, slice]]:
    """(row slice, function slice) blocks covering a (bsz, k) output whose
    (rows, p, functions) lanes stay within :data:`LANES`."""
    p = max(int(p), 1)
    kc = max(1, min(int(k), LANES // p))
    bc = max(1, LANES // (p * kc))
    for r in range(0, int(bsz), bc):
        for f in range(0, int(k), kc):
            yield slice(r, r + bc), slice(f, f + kc)


def elements(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded rows (B, P), pad = -1 -> (valid mask, int64 elements with the
    pads at 0)."""
    valid = idx >= 0
    return valid, torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int64)


def hash_lanes(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a*x + b) mod 2^32`` for every lane: x (Bc, P) int64 in ``[0, 2^31)``,
    a, b (kc,) int64 in ``[0, 2^32)`` -> (Bc, P, kc) int64. ``a*x < 2^63``, so
    the product is exact before the mask."""
    h = x[:, :, None] * a
    h += b
    h &= U32
    return h
