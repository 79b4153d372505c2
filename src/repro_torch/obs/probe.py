"""Exact Jaccard top-k — the ground truth recall is measured against.

The contract of ``repro.obs.probe.exact_topk``: (Q, k) *positions* into the
corpus, score descending, position ascending on ties. |q ∩ c| is a float32
product of {0,1} membership matrices, built one corpus chunk at a time on the
given device; |q ∪ c| follows by inclusion-exclusion. The counts are integers
below 2^24, so float32 holds them exactly — as long as the product runs in
full float32: TF32 is switched off for it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = ["exact_topk"]

# float32 membership elements of one corpus chunk (256 MB)
_CHUNK_ELEMS = 1 << 26


def _membership(idx: np.ndarray, d: int, device: torch.device) -> torch.Tensor:
    rows = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(device)
    m = torch.zeros((rows.shape[0], d), dtype=torch.float32, device=device)
    keep = rows >= 0
    r = torch.arange(rows.shape[0], device=device)[:, None].expand_as(rows)
    m[r[keep], rows[keep].to(torch.int64)] = 1.0
    return m


def exact_topk(corpus_idx, query_idx, k: int, device="cuda") -> np.ndarray:
    """Exact Jaccard top-k of padded sparse ``query_idx`` rows over
    ``corpus_idx`` rows (both numpy, pad -1). Returns (Q, k) int64 positions."""
    dev = resolve_device(device)
    corpus_idx = np.asarray(corpus_idx)
    query_idx = np.asarray(query_idx)
    d = int(max(corpus_idx.max(initial=0), query_idx.max(initial=0))) + 1
    qm = _membership(query_idx, d, dev)
    q_sizes = qm.sum(dim=1, keepdim=True)
    n = len(corpus_idx)
    sims = torch.empty((len(query_idx), n), dtype=torch.float32, device=dev)
    chunk = max(1, _CHUNK_ELEMS // d)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # exact integer counts
    try:
        for lo in range(0, n, chunk):
            cm = _membership(corpus_idx[lo : lo + chunk], d, dev)
            inter = qm @ cm.T
            union = q_sizes + cm.sum(dim=1)[None, :] - inter
            sims[:, lo : lo + cm.shape[0]] = inter / torch.clamp_min(union, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    order = torch.sort(sims, dim=1, descending=True, stable=True).indices[:, :k]
    return order.cpu().numpy()
