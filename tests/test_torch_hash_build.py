"""Port parity, hash mode: ``hopper.ops.hash_build_sketch`` (the multiply-shift
map fused into the build, for huge d where no Ψ table exists) against
``repro.kernels.ops.hash_build_sketch`` in interpret mode and against
``map_indices`` in hash mode followed by the build, on the JAX package's
coefficients. Packed words are integers and must be bit-equal. The cases of
``tests/test_kernels.py::test_hash_build_matches_hash_mode_reference``, plus
N < 32, a row of pads only, indices at 2^31 - 1 and coefficients with the top
bit set (the uint32 wraparound); then a hash-mode store built through the
kernel's wrapper serves as one built through ``map_indices``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import make_mapping as j_make_mapping
from repro.core import map_indices as j_map_indices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import config_from_reference, mapping_from_reference
from repro_torch.core import BinSketchConfig, make_mapping, map_indices
from repro_torch.data.synthetic import DATASETS, generate_corpus
from repro_torch.engine import SketchEngine
from repro_torch.hopper import ops, ref

CPU = "cpu"


def _raw(rng, b, p, top=2**31 - 1):
    """(b, p) raw indices, ragged rows padded with -1, row 0 all pads."""
    idx = np.full((b, p), -1, np.int32)
    for i, ln in enumerate(rng.integers(0, p + 1, b)):
        idx[i, :ln] = rng.integers(0, top, ln)
    idx[0] = -1
    if b > 1 and p:
        idx[1, 0] = top  # the largest index
    return idx


@pytest.mark.parametrize("b,p,n_bins", [(3, 9, 100), (16, 64, 2048), (7, 33, 517),
                                        (5, 10, 20), (2, 3, 1)])
def test_hash_build_matches_reference(b, p, n_bins):
    """The wrapper's plain version == the JAX Pallas kernel (interpret) ==
    JAX ``map_indices`` in hash mode + ``build_sketch_ref`` == the port's
    ``map_indices`` + ``build_sketch``, on the JAX package's coefficients and
    on coefficients with every bit set."""
    rng = np.random.default_rng(p)
    jcfg = JCfg(d=1 << 30, n_bins=n_bins, mode="hash")
    idx = _raw(rng, b, p)
    tcfg = config_from_reference(jcfg.d, n_bins, "hash")
    for jco in (j_make_mapping(jcfg, jax.random.PRNGKey(3)),
                jnp.asarray([0xFFFFFFFF, 0xFFFFFFFF], jnp.uint32)):
        want = np.asarray(jref.build_sketch_ref(j_map_indices(jcfg, jco, jnp.asarray(idx)),
                                                n_bins))
        np.testing.assert_array_equal(
            np.asarray(jops.hash_build_sketch(jnp.asarray(idx), jco, n_bins, interpret=True)),
            want)
        tco = mapping_from_reference(np.asarray(jco), tcfg, CPU)
        tidx = torch.from_numpy(idx)
        got = ops.hash_build_sketch(tidx, tco, n_bins)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(ref.hash_build_ref(tidx, tco, n_bins).numpy()
                                      .view(np.uint32), want)
        np.testing.assert_array_equal(
            ops.build_sketch(map_indices(tcfg, tco, tidx), n_bins).numpy().view(np.uint32), want)
        assert not want[0].any()  # a row of pads sets no bit


def test_hash_build_contract():
    """int32 indices and a (2,) integer coefficient tensor only; an empty
    batch gives (0, W); bits at and above N stay zero."""
    co = torch.tensor([3, 5], dtype=torch.int64)
    with pytest.raises(TypeError):
        ops.hash_build_sketch(torch.zeros((2, 3), dtype=torch.int64), co, 64)
    with pytest.raises(TypeError):
        ops.hash_build_sketch(torch.zeros((2, 3), dtype=torch.int32), co.float(), 64)
    with pytest.raises(TypeError):
        ops.hash_build_sketch(torch.zeros((2, 3), dtype=torch.int32), co[:1], 64)
    assert ops.hash_build_sketch(torch.zeros((0, 3), dtype=torch.int32), co, 70).shape == (0, 3)
    idx = torch.from_numpy(_raw(np.random.default_rng(0), 64, 40))
    words = ops.hash_build_sketch(idx, co, 37)
    assert not (words[:, 1] >> 5).any()  # bits 37..63 of the last word


def test_hash_mode_store_serves_like_mapped_build():
    """``tiny`` sketched in hash mode through ``hash_build_sketch`` and
    bulk-loaded with ``add_sketches`` holds the same words, and answers the
    same queries, as an engine that sketches through ``map_indices``."""
    spec = DATASETS["tiny"]
    idx, lens = generate_corpus(spec, seed=0)
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), 0.05, mode="hash")
    coeffs = make_mapping(cfg, seed=0, device=CPU)
    fused = SketchEngine.build(cfg, coeffs, backend="cuda", capacity=len(idx))
    for s in range(0, len(idx), 64):
        fused.store.add_sketches(ops.hash_build_sketch(torch.from_numpy(idx[s : s + 64]),
                                                       coeffs, cfg.n_bins))
    mapped = SketchEngine.build(cfg, coeffs, idx, backend="reference")
    assert torch.equal(fused.store.sketches, mapped.store.sketches)
    assert torch.equal(fused.store.fills, mapped.store.fills)
    q = idx[:16]
    got, want = fused.query(q, 5), mapped.query(q, 5)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=1e-3)
    assert (got[1][:, 0] == torch.arange(16, dtype=torch.int32)).all()
