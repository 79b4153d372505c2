"""Import hygiene of the PyTorch port: it never imports JAX or the JAX package,
it imports with no CUDA present, and its "cuda" default raises there instead
of falling back to the CPU."""

import ast
import importlib
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "examples" / "quickstart_torch.py",
                                         REPO / "examples" / "ranking_service_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_without_cuda_and_default_raises(monkeypatch):
    """Every module imports on a host with no card; the default device then
    raises at each entry point — no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "repro_torch.hopper.ops" in names and "repro_torch.launch.serve" in names
    for new in ("repro_torch.engine.banding", "repro_torch.hopper.band_hash",
                "repro_torch.hopper.hash_build", "repro_torch.faults",
                "repro_torch.obs.clock", "repro_torch.obs.metrics",
                "repro_torch.engine.supervision", "repro_torch.checkpoint.manager",
                "repro_torch.obs.trace", "repro_torch.obs.probe",
                "repro_torch.engine.lifecycle", "repro_torch.core.baselines.bcs",
                "repro_torch.core.baselines.minhash", "repro_torch.core.baselines.doph",
                "repro_torch.core.baselines.oddsketch", "repro_torch.core.baselines.simhash",
                "repro_torch.core.baselines.cbe", "repro_torch.core.categorical",
                "repro_torch.data.dedup"):
        assert new in names

    import repro_torch
    from repro_torch import convert
    from repro_torch.core import BinSketchConfig, make_mapping
    from repro_torch.core.baselines import bcs, cbe, doph, minhash, oddsketch, simhash
    from repro_torch.data.dedup import find_near_duplicates
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.launch.serve import serve
    from repro_torch.obs.probe import exact_topk

    cfg = BinSketchConfig(d=100, n_bins=64)
    idx = np.zeros((2, 3), np.int32)
    for call in (lambda: repro_torch.resolve_device(),
                 lambda: make_mapping(cfg),
                 lambda: convert.mapping_from_reference(np.zeros(100, np.int32), cfg),
                 lambda: convert.packed_from_reference(np.zeros((1, 2), np.uint32)),
                 lambda: exact_topk(idx, idx, 1),
                 lambda: serve(DATASETS["tiny"]),
                 lambda: find_near_duplicates(idx, 100),
                 lambda: bcs.make_mapping(100, 64),
                 lambda: minhash.make_hashes(4),
                 lambda: doph.make_hashes(),
                 lambda: oddsketch.make_hashes(4),
                 lambda: simhash.make_hashes(4),
                 lambda: cbe.make_params(100)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_never_fall_back():
    """A tensor that is not on the CPU reaches the kernel launch, never the
    plain version: off the card, the launch refuses it."""
    from repro_torch.hopper import ops

    words = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.build_sketch(words, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.sketch_score(words, words, 64, a_fills=torch.zeros(4, dtype=torch.int32,
                                                                 device="meta"),
                         b_fills=torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.count_bins(words, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rebucket(words, 64, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.band_hash(words, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.hash_build_sketch(words, torch.tensor([3, 5], device="meta"), 64)
