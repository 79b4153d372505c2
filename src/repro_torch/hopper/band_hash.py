"""Launch of ``csrc/band_hash.cu``: packed rows -> banded LSH keys.

Replaces ``kernels/band_hash.py::band_hash_kernel``. One thread per (row,
band) runs the xorshift-multiply chain over the band's words in ``uint32_t``;
words past W read as zero, so the words go in unpadded. Bound by bytes
(``4*B*W`` read, ``4*B*nb_eff`` written).
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["launch"]


def launch(packed: torch.Tensor, nb_eff: int, wpb: int) -> torch.Tensor:
    """``packed: (B, W)`` int32 CUDA tensor -> ``(B, nb_eff)`` int32 keys
    (uint32 bits); ``nb_eff * wpb >= W`` from ``core.packed.band_shape``."""
    build.require_cuda(packed, "band_hash")
    packed = packed.contiguous()
    b, w = packed.shape
    out = torch.empty((b, int(nb_eff)), dtype=torch.int32, device=packed.device)
    lib = build.library("band_hash")
    with torch.cuda.device(packed.device):
        err = lib.band_hash(packed.data_ptr(), b, w, int(nb_eff), int(wpb), out.data_ptr(),
                            build.stream_handle(packed))
    build.check(lib, err, "band_hash")
    return out
