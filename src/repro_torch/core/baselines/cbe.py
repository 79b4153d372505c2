"""CBE — Circulant Binary Embedding [Yu et al. 2014].

sketch(x) = sign( circ(r) @ (D x) )[:k]   with D a random sign flip and
circ(r) applied via FFT in O(d log d) — the "faster SimHash"
(``repro.core.baselines.cbe``). It needs the dense vector, so sparse rows are
densified a block of rows at a time (charged in the time readings). The
projection runs in float32 (``torch.fft``), as the reference's does in XLA;
a projection within rounding of 0 may take either sign across the two.

Estimator: identical to SimHash (sign-agreement -> angle).
"""

from __future__ import annotations

import torch

from ... import resolve_device
from ._hashing import elements, generator
from .simhash import estimates  # same estimator — re-exported

__all__ = ["make_params", "project_dense", "project_indices", "sketch_dense",
           "sketch_indices", "estimates"]

_DENSE_ELEMS = 1 << 27  # float32 elements of one densified (rows, d) block


def make_params(d: int, seed: int = 0, device="cuda"):
    """(the spectrum of circ(r), (d//2+1,) complex64; signs D, (d,) float32)."""
    dev = resolve_device(device)
    gen = generator(seed)
    r = torch.randn((int(d),), generator=gen, dtype=torch.float32)
    signs = torch.randint(0, 2, (int(d),), generator=gen).to(torch.float32) * 2.0 - 1.0
    return torch.fft.rfft(r).to(dev), signs.to(dev)


def project_dense(params, k: int, x: torch.Tensor) -> torch.Tensor:
    """Dense rows (B, d) -> (B, k) float32 projections ``(circ(r) D x)[:k]``."""
    r_hat, signs = params
    y = torch.fft.irfft(torch.fft.rfft(x * signs[None, :], dim=1) * r_hat[None, :],
                        n=signs.shape[0], dim=1)
    return y[:, : int(k)]


def sketch_dense(params, k: int, x: torch.Tensor) -> torch.Tensor:
    """Dense rows (B, d) -> (B, k) uint8 sign bits (1 where the projection >= 0)."""
    return (project_dense(params, k, x) >= 0).to(torch.uint8)


def project_indices(params, k: int, d: int, idx: torch.Tensor) -> torch.Tensor:
    """Padded sparse rows (B, P) -> (B, k) float32 projections, densified in
    blocks of rows; a pad slot adds nothing (a max with 0 at column 0)."""
    signs = params[1]
    valid, x = elements(idx.to(signs.device))
    out = torch.empty((x.shape[0], int(k)), dtype=torch.float32, device=x.device)
    step = max(1, _DENSE_ELEMS // max(int(d), 1))
    for lo in range(0, x.shape[0], step):
        blk = x[lo : lo + step]
        dense = torch.zeros((blk.shape[0], int(d)), dtype=torch.float32, device=x.device)
        dense.scatter_reduce_(1, blk, valid[lo : lo + step].to(torch.float32), "amax")
        out[lo : lo + step] = project_dense(params, k, dense)
    return out


def sketch_indices(params, k: int, d: int, idx: torch.Tensor) -> torch.Tensor:
    """Padded sparse rows (B, P) -> densify -> (B, k) uint8 sign bits."""
    return (project_indices(params, k, d, idx) >= 0).to(torch.uint8)
