"""End-to-end serving example of the PyTorch port: the paper's ranking workload as a
service, on the card.

    PYTHONPATH=src python examples/ranking_service_torch.py [--dataset kos]
    PYTHONPATH=src python examples/ranking_service_torch.py --device cpu

Build: sketch the corpus once (single pass). Serve: batched queries scored
in packed sketch space (the Hopper kernels on the card, their plain PyTorch
versions on the CPU), top-k with recall against exact Jaccard. This is
``repro_torch.launch.serve`` — the port's serving launcher — invoked as a
library; the counterpart of ``examples/ranking_service.py``.
"""

import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tiny", choices=["tiny", "kos", "bbc", "enron", "nytimes"])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--backend", default="auto", help="engine backend (auto | cuda | reference)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of the kernels")
    args = ap.parse_args(argv)
    return serve.main([
        "--dataset", args.dataset,
        "--queries", str(args.queries),
        "--topk", str(args.topk),
        "--backend", args.backend,
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
