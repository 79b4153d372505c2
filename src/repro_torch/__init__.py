"""repro_torch — BinSketch serving in PyTorch, with Hopper kernels written in CUDA C++.

The PyTorch counterpart of the JAX package ``repro``. It imports ``torch`` and
``numpy`` and nothing of ``repro``: the two packages meet only in the tests,
which feed both the same numpy inputs and hold this one to the other's result.

Layout (the slices of the JAX package so far: append-only serving; the
mutable arm with distillation and mixed-width queries; the banded prefilter
and hash mode; the operations plane of supervision, fault injection,
background jobs and checkpoints; the telemetry plane):

| piece | module | role |
|---|---|---|
| packed words | core/packed.py | int32 words holding uint32 bits, SWAR popcount |
| BinSketch | core/binsketch.py | config, Ψ map, scatter sketch construction |
| estimators | core/estimators.py | Algorithms 1-4 from fill and AND counts |
| counting sketch | core/counting.py | per-bin occupancy counters of the mutable head |
| corpora | data/synthetic.py | the numpy generator, same seed -> same rows |
| kernels | hopper/ | CUDA kernels for build, score, streaming top-k, occupancy count and width fold, with plain twins |
| engine | engine/ | backends, planner, append-only and segmented stores, banded prefilter, job supervisor, SketchEngine |
| checkpoints | checkpoint/manager.py | atomic, async, CRC-verified checkpoints on the reference's layout |
| fault injection | faults.py | seeded fault plans over named injection points |
| time and metrics | obs/clock.py, obs/metrics.py | the injectable clock; counters, gauges, histograms |
| query traces | obs/trace.py | sampled per-query stages, timed by CUDA events on the card |
| ground truth | obs/probe.py | exact Jaccard top-k; the online recall probe |
| driver | launch/serve.py | the paper's ranking experiment as a service, append-only or mutable |
| state from the reference | convert.py | Ψ tables, packed words and whole stores of the JAX package |

Every entry point takes ``device`` and defaults to ``"cuda"``; without a card
that default raises (:func:`resolve_device`). The CPU runs only when a caller
asks for it, as the tests do, and then every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and no
    card is present. There is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
