"""Port parity, core modules: packed words, BinSketch, estimators, corpora,
planner — the same numpy inputs through ``repro`` (JAX, CPU) and
``repro_torch`` (device="cpu").

Integer outputs (words, popcounts, AND-counts, bins, sketches) must be
bit-equal. Float32 estimators run the same formula in both packages and are
held at rtol 1e-5 / atol 1e-6 (the engine's tie tolerance)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import estimators as jest
from repro.core import make_mapping as j_make_mapping
from repro.core import packed as jpk
from repro.core import binsketch as jbs
from repro.data import synthetic as jsyn
from repro.engine.planner import QueryPlanner as JPlanner
from repro_torch.convert import (
    config_from_reference,
    mapping_from_reference,
    packed_from_reference,
    packed_to_reference,
)
from repro_torch.core import binsketch as tbs
from repro_torch.core import estimators as t_est
from repro_torch.core import packed as tpk
from repro_torch.data import synthetic as tsyn
from repro_torch.engine.planner import QueryPlanner as TPlanner

RNG = np.random.default_rng(7)
CPU = "cpu"


def rand_words(n, n_bins):
    w = (n_bins + 31) // 32
    x = RNG.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    tail = w * 32 - n_bins
    if tail:
        x[:, -1] &= np.uint32(0xFFFFFFFF) >> np.uint32(tail)
    return x


def t(words):
    return packed_from_reference(words, CPU)


def rand_idx(b, p, hi, fill=0.8):
    out = np.full((b, p), -1, np.int32)
    for i, ln in enumerate(RNG.integers(0, int(p * fill) + 1, b)):
        out[i, :ln] = RNG.integers(0, hi, ln)
    return out


# ------------------------------------------------------------------ packed
@pytest.mark.parametrize("n_bins", [1, 31, 32, 33, 100, 517])
def test_packed_bit_equal(n_bins):
    words = rand_words(9, n_bins)
    tw = t(words)
    assert tpk.num_words(n_bins) == jpk.num_words(n_bins)
    bits = tpk.unpack_bits(tw, n_bins)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jpk.unpack_bits(jnp.asarray(words), n_bins)))
    np.testing.assert_array_equal(packed_to_reference(tpk.pack_bits(bits)), words)
    np.testing.assert_array_equal(
        packed_to_reference(tpk.popcount(tw)).astype(np.uint32),
        np.asarray(jpk.popcount(jnp.asarray(words))))
    np.testing.assert_array_equal(tpk.row_popcount(tw).numpy(),
                                  np.asarray(jpk.row_popcount(jnp.asarray(words))))
    other = rand_words(13, n_bins)
    np.testing.assert_array_equal(
        tpk.and_popcount_pairwise(tw, t(other)).numpy(),
        np.asarray(jpk.and_popcount_pairwise(jnp.asarray(words), jnp.asarray(other))))


def test_packed_extreme_words():
    """All-ones, sign-bit-only and zero words: where int32 arithmetic shifts
    and overflows would show."""
    words = np.array([[0xFFFFFFFF, 0x80000000, 0, 0x7FFFFFFF, 1]], np.uint32)
    tw = t(words)
    np.testing.assert_array_equal(tpk.popcount(tw).numpy()[0], [32, 1, 0, 31, 1])
    np.testing.assert_array_equal(packed_to_reference(tw), words)
    np.testing.assert_array_equal(tpk.unpack_bits(tw, 160).numpy(),
                                  np.asarray(jpk.unpack_bits(jnp.asarray(words), 160)))


# --------------------------------------------------------------- binsketch
@pytest.mark.parametrize("psi,rho", [(1, 0.5), (96, 0.05), (870, 0.05), (460, 0.1)])
def test_theorem1_and_config(psi, rho):
    assert tbs.theorem1_N(psi, rho) == jbs.theorem1_N(psi, rho)
    tc = tbs.BinSketchConfig.from_sparsity(5000, psi, rho)
    jc = JCfg.from_sparsity(5000, psi, rho)
    assert (tc.d, tc.n_bins, tc.mode, tc.n_words) == (jc.d, jc.n_bins, jc.mode, jc.n_words)


@pytest.mark.parametrize("mode,d,n_bins", [("table", 5000, 600), ("table", 2048, 33),
                                           ("hash", 1 << 30, 517), ("hash", 1 << 30, 1000)])
def test_sketch_indices_bit_equal(mode, d, n_bins):
    """map_indices and both sketch constructions, under the reference's own
    Ψ map carried across, in table and hash mode."""
    jc = JCfg(d=d, n_bins=n_bins, mode=mode)
    jmap = j_make_mapping(jc, jax.random.PRNGKey(3))
    tc = config_from_reference(d, n_bins, mode)
    tmap = mapping_from_reference(np.asarray(jmap), tc, CPU)
    idx = rand_idx(11, 64, min(d, 2**31 - 1))
    bins = tbs.map_indices(tc, tmap, torch.from_numpy(idx))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbs.map_indices(jc, jmap, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tbs.sketch_indices_dense(tc, tmap, torch.from_numpy(idx)).numpy(),
        np.asarray(jbs.sketch_indices_dense(jc, jmap, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        packed_to_reference(tbs.sketch_indices(tc, tmap, torch.from_numpy(idx))),
        np.asarray(jbs.sketch_indices(jc, jmap, jnp.asarray(idx))))


@pytest.mark.parametrize("mode", ["table", "hash"])
def test_make_mapping_seeded(mode):
    cfg = tbs.BinSketchConfig(d=4000, n_bins=300, mode=mode)
    m1 = tbs.make_mapping(cfg, seed=5, device=CPU)
    assert torch.equal(m1, tbs.make_mapping(cfg, seed=5, device=CPU))
    assert not torch.equal(m1, tbs.make_mapping(cfg, seed=6, device=CPU))
    if mode == "table":
        assert m1.dtype == torch.int32 and m1.shape == (4000,)
        assert int(m1.min()) >= 0 and int(m1.max()) < 300
    else:
        assert m1.dtype == torch.int64 and m1.shape == (2,)
        assert int(m1[0]) % 2 == 1 and 0 <= int(m1.min()) and int(m1.max()) < 2**32


def test_config_rejects_bad_values():
    with pytest.raises(ValueError):
        tbs.BinSketchConfig(d=10, n_bins=0)
    with pytest.raises(ValueError):
        tbs.BinSketchConfig(d=10, n_bins=8, mode="dense")
    with pytest.raises(ValueError):
        tbs.theorem1_N(0)


# -------------------------------------------------------------- estimators
@pytest.mark.parametrize("n_bins", [2, 100, 424, 6017])
def test_cardinality_from_fill(n_bins):
    counts = np.unique(np.concatenate([[0, 1, n_bins - 1, n_bins],
                                       RNG.integers(0, n_bins + 1, 50)])).astype(np.int32)
    got = t_est.cardinality_from_fill(torch.from_numpy(counts), n_bins).numpy()
    want = np.asarray(jest.cardinality_from_fill(jnp.asarray(counts), n_bins))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all()  # a full sketch saturates, never inf


@pytest.mark.parametrize("convention", ["symmetric", "paper"])
@pytest.mark.parametrize("measure", ["ip", "hamming", "jaccard", "cosine"])
def test_pairwise_similarity(measure, convention):
    n_bins = 517
    a, b = rand_words(6, n_bins), rand_words(23, n_bins)
    na, nb, nab = t_est.pairwise_counts(t(a), t(b))
    est_t = t_est.estimates_from_counts(na[:, None], nb[None, :], nab, n_bins, convention)
    jna, jnb, jnab = jest.pairwise_counts(jnp.asarray(a), jnp.asarray(b))
    est_j = jest.estimates_from_counts(jna[:, None], jnb[None, :], jnab, n_bins, convention)
    np.testing.assert_array_equal(nab.numpy(), np.asarray(jnab))
    np.testing.assert_allclose(est_t[measure].numpy(), np.asarray(est_j[measure]),
                               rtol=1e-5, atol=1e-6)
    if convention == "symmetric":
        got = t_est.pairwise_similarity(t(a), t(b), n_bins, measure,
                                        a_fills=na, b_fills=nb)
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(jest.pairwise_similarity(jnp.asarray(a), jnp.asarray(b), n_bins, measure)),
            rtol=1e-5, atol=1e-6)


def test_estimators_reject_unknown_names():
    a = t(rand_words(2, 64))
    with pytest.raises(ValueError):
        t_est.pairwise_similarity(a, a, 64, measure="dice")
    with pytest.raises(ValueError):
        t_est.estimates_from_counts(torch.ones(1, dtype=torch.int32),
                                    torch.ones(1, dtype=torch.int32),
                                    torch.ones(1, dtype=torch.int32), 64, "other")


# ------------------------------------------------------- corpora, planner
@pytest.mark.parametrize("name,n_points", [("tiny", None), ("nytimes", 300), ("enron", 200)])
def test_generate_corpus_same_rows(name, n_points):
    ts, js = tsyn.DATASETS[name], jsyn.DATASETS[name]
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    if n_points is not None:
        ts = dataclasses.replace(ts, n_points=n_points)
        js = dataclasses.replace(js, n_points=n_points)
    ti, tl = tsyn.generate_corpus(ts, seed=3)
    ji, jl = jsyn.generate_corpus(js, seed=3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


def test_planner_matches_reference():
    sizes = [1, 7, 8, 9, 33, 100, 256, 1000, 1025, 3000]
    for lo, hi in [(8, 1024), (8, 256), (1, 32)]:
        tp, jp = TPlanner(lo, hi), JPlanner(lo, hi)
        for n in sizes:
            assert [dataclasses.astuple(c) for c in tp.plan(n)] == \
                   [dataclasses.astuple(c) for c in jp.plan(n)]
        assert tp.shapes(sizes) == jp.shapes(sizes)
    with pytest.raises(ValueError):
        TPlanner(16, 8)
