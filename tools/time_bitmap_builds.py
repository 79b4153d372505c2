#!/usr/bin/env python3
"""Time the two bitmap-build wrappers of one checkout of the port on the card.

    python3 tools/time_bitmap_builds.py [--src DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout's), and at
the hash-mode ingest shape (16384 NYTimes-shaped rows of 870 ids, N=5859)
times ``ops.build_sketch`` on their mapped bins and ``ops.hash_build_sketch``
on the raw ids, with ``make_mapping``'s int64 coefficients on the card: the
CUDA-event median of the whole call (``chip_smoke.cuda_ms``, 20 calls) and,
for each device kernel the call launches, its mean duration and count a
call as ``torch.profiler`` records them over 20 calls
(``chip_smoke.profiled_calls``). Both wrappers' outputs are held to
their plain versions first. Prints the card and one JSON line.

To compare two checkouts, run it on each in turns (A, B, B, A) on one
card: each run is its own process, so it imports its own ``repro_torch``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def kernel_breakdown(torch, fn) -> dict:
    """{kernel name: [mean ms a call, launches a call]} of ``fn``'s device
    kernels over 20 calls (``chip_smoke.profiled_calls``)."""
    from chip_smoke import profiled_calls

    runs = profiled_calls(torch, fn)
    out = collections.defaultdict(lambda: [0.0, 0])
    for name, ms in runs[0]:
        out[name][1] += 1
    for run in runs:
        for name, ms in run:
            out[name][0] += ms / len(runs)
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=pathlib.Path, default=ROOT,
                    help="checkout whose src/repro_torch is timed (default: this one)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_bitmap_builds: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms
    from repro_torch.core import BinSketchConfig, make_mapping, map_indices
    from repro_torch.data.synthetic import DATASETS, generate_corpus
    from repro_torch.hopper import ops, ref

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    spec = dataclasses.replace(DATASETS["nytimes"], n_points=16384)
    idx, _ = generate_corpus(spec, seed=0)
    rows = torch.from_numpy(idx).to(dev)
    n_bins = 5859
    cfg = BinSketchConfig(d=spec.d, n_bins=n_bins)
    bins = map_indices(cfg, make_mapping(cfg, seed=0, device=dev), rows)
    coeffs = make_mapping(BinSketchConfig(d=spec.d, n_bins=n_bins, mode="hash"), seed=0,
                          device=dev)
    calls = {"build_sketch": lambda: ops.build_sketch(bins, n_bins),
             "hash_build_sketch": lambda: ops.hash_build_sketch(rows, coeffs, n_bins)}
    plain = {"build_sketch": lambda: ref.build_sketch_ref(bins, n_bins),
             "hash_build_sketch": lambda: ref.hash_build_ref(rows, coeffs, n_bins)}
    result = {"src": str(args.src), "card": card, "shape": list(rows.shape), "n_bins": n_bins}
    for name, fn in calls.items():
        if not torch.equal(fn(), plain[name]()):
            print(f"time_bitmap_builds: {name} differs from its plain version", file=sys.stderr)
            return 1
        result[name] = {"ms": cuda_ms(torch, fn, 20), "kernels": kernel_breakdown(torch, fn)}
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
