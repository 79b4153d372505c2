"""Port parity, kernel wrappers: ``repro_torch.hopper.ops`` on CPU tensors (the
plain versions) against ``repro.kernels.ops`` run as its own tests run it here
(Pallas in interpret mode) and against its plain ``kernels/ref.py``.

Tolerances: packed words and AND-counts bit-equal; float32 scores allclose at
rtol 1e-5 / atol 1e-6 against ``ops.sketch_score`` (the same fused epilogue
formula); against the estimator oracle (``estimators.pairwise_similarity``)
at the rtol 2e-3 / atol 1e-3 ``tests/test_kernels.py`` uses, because the
oracle divides by ``log1p(-1/N)`` where the epilogue multiplies by its
rounded inverse, and the Jaccard/IP cancellation magnifies those few ulp
(the same reason the port's epilogue mirrors the kernel's fused
multiply-adds: see ``repro_torch.hopper.ref.score_epilogue``).
Top-k results go through the tie-aware ``assert_topk_equivalent``.
Interpret-mode calls are few: each new shape compiles for seconds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as jest
from repro.engine.testing import assert_topk_equivalent
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import packed_from_reference, packed_to_reference
from repro_torch.core import packed as tpk
from repro_torch.hopper import ops

RNG = np.random.default_rng(11)
MEASURES = ["ip", "hamming", "jaccard", "cosine"]


def rand_bins(b, p, n_bins, fill=0.7):
    out = np.full((b, p), -1, np.int32)
    for i, ln in enumerate(RNG.integers(0, int(p * fill) + 1, b)):
        out[i, :ln] = RNG.integers(0, n_bins, ln)
    return out


def rand_words(n, n_bins, density=0.5):
    w = (n_bins + 31) // 32
    bits = (RNG.random((n, w * 32)) < density).astype(np.uint64)
    bits[:, n_bins:] = 0
    x = (bits.reshape(n, w, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    return x.astype(np.uint32)


def t(x):
    return packed_from_reference(x, "cpu")


def truth_rows(s):
    """Per-query {id: score} maps of a (Q, C) matrix (tie-aware check)."""
    s = np.asarray(s)
    return [{j: float(s[r, j]) for j in range(s.shape[1])} for r in range(s.shape[0])]


# ------------------------------------------------------------------- build
@pytest.mark.parametrize("b,p,n_bins,interpret", [
    (1, 4, 32, False), (5, 17, 100, True), (16, 64, 2048, False),
    (3, 7, 33, True), (9, 129, 511, True), (64, 256, 4096, False)])
def test_build_sketch_bit_equal(b, p, n_bins, interpret):
    """Shape sweep of tests/test_kernels.py; bins < N (the Pallas wrapper
    sets out-of-range bins in the last word, see the next test)."""
    bins = rand_bins(b, p, n_bins)
    got = ops.build_sketch(torch.from_numpy(bins), n_bins)
    assert got.dtype == torch.int32 and got.shape == (b, (n_bins + 31) // 32)
    want = (jops.build_sketch(jnp.asarray(bins), n_bins) if interpret
            else jref.build_sketch_ref(jnp.asarray(bins), n_bins))
    np.testing.assert_array_equal(packed_to_reference(got), np.asarray(want))


def test_build_sketch_drops_out_of_range_bins():
    """Bins >= N set no bit: the documented contract and ``ref.build_sketch_ref``
    (the Pallas wrapper would set bit 1 of word 1 for bin 33 at N=33)."""
    bins = np.array([[33, 5, -1, 40], [0, 32, 63, -1]], np.int32)
    got = packed_to_reference(ops.build_sketch(torch.from_numpy(bins), 33))
    np.testing.assert_array_equal(got, np.asarray(jref.build_sketch_ref(jnp.asarray(bins), 33)))
    np.testing.assert_array_equal(got, [[32, 0], [1, 1]])


# ------------------------------------------------------------------- score
@pytest.mark.parametrize("measure", ["counts"] + MEASURES)
def test_sketch_score_matches_pallas(measure):
    """Ragged shape (nothing divides a block) through the interpret-mode
    Pallas wrapper, every measure."""
    q, c, n_bins = 9, 130, 517
    a, b = rand_words(q, n_bins, 0.2), rand_words(c, n_bins, 0.2)
    got = ops.sketch_score(t(a), t(b), n_bins, measure).numpy()
    want = np.asarray(jops.sketch_score(jnp.asarray(a), jnp.asarray(b), n_bins=n_bins,
                                        measure=measure))
    if measure == "counts":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q,c,n_bins", [(4, 9, 100), (7, 300, 2048), (130, 140, 1000)])
def test_sketch_score_sweep_matches_pallas(q, c, n_bins):
    """The shape sweep of tests/test_kernels.py, on ``ip``: the measure whose
    cancellation magnifies a rounding difference most."""
    a, b = rand_words(q, n_bins, 0.1), rand_words(c, n_bins, 0.1)
    got = ops.sketch_score(t(a), t(b), n_bins, "ip").numpy()
    want = jops.sketch_score(jnp.asarray(a), jnp.asarray(b), n_bins=n_bins, measure="ip")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q,c,n_bins", [(4, 9, 100), (7, 300, 2048), (130, 140, 1000)])
@pytest.mark.parametrize("measure", ["counts"] + MEASURES)
def test_sketch_score_matches_plain_reference(q, c, n_bins, measure):
    """Counts bit-equal to ``kernels/ref.py``; measures against the estimator
    oracle at its tolerance."""
    a, b = rand_words(q, n_bins, 0.1), rand_words(c, n_bins, 0.1)
    got = ops.sketch_score(t(a), t(b), n_bins, measure).numpy()
    if measure == "counts":
        counts = jref.score_counts_ref(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(got, np.asarray(counts).astype(np.float32))
        return
    oracle = jest.pairwise_similarity(jnp.asarray(a), jnp.asarray(b), n_bins, measure)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-3, atol=1e-3)


def test_sketch_score_fills_pass_through():
    """Given fills are used as given (the store's cache), None popcounts."""
    a, b = t(rand_words(5, 300)), t(rand_words(8, 300))
    base = ops.sketch_score(a, b, 300, "jaccard")
    same = ops.sketch_score(a, b, 300, "jaccard", a_fills=tpk.row_popcount(a), b_fills=None)
    torch.testing.assert_close(base, same, rtol=0, atol=0)
    off = ops.sketch_score(a, b, 300, "jaccard", a_fills=torch.zeros(5, dtype=torch.int32))
    assert not torch.equal(base, off)


def test_wrappers_reject_bad_input():
    w = torch.zeros((4, 4), dtype=torch.int32)
    for bad in (w.to(torch.int64), w.to(torch.uint8)):
        with pytest.raises(TypeError):
            ops.sketch_score(bad, w, 128)
        with pytest.raises(TypeError):
            ops.sketch_topk(w, bad, 128, k=2)
        with pytest.raises(TypeError):
            ops.build_sketch(bad, 128)
    with pytest.raises(ValueError):
        ops.sketch_topk(w, w, 128, k=0)
    with pytest.raises(ValueError):
        ops.sketch_score(w, w, 128, "dice")


# -------------------------------------------------------------------- topk
@pytest.mark.parametrize("q,c,n_bins,k,measure", [
    (5, 37, 101, 5, "jaccard"),    # nothing divides any block size
    (9, 130, 517, 10, "cosine"),   # corpus spans blocks, word axis ragged
    (4, 6, 128, 10, "hamming"),    # k > C: the -inf / -1 tail
])
def test_sketch_topk_matches_pallas(q, c, n_bins, k, measure):
    a, b = rand_words(q, n_bins, 0.1), rand_words(c, n_bins, 0.1)
    got = ops.sketch_topk(t(a), t(b), n_bins, measure, k=k)
    want = jops.sketch_topk(jnp.asarray(a), jnp.asarray(b), n_bins=n_bins,
                            measure=measure, k=k)
    s = jops.sketch_score(jnp.asarray(a), jnp.asarray(b), n_bins=n_bins, measure=measure)
    assert got[0].shape == got[1].shape == (q, k) and got[1].dtype == torch.int32
    assert_topk_equivalent((got[0].numpy(), got[1].numpy()), want, truth_rows(s))
    if k > c:
        assert (got[0][:, c:] == -np.inf).all() and (got[1][:, c:] == -1).all()


def test_sketch_topk_mask_matches_pallas():
    n_bins, q, c = 256, 5, 40
    a, b = rand_words(q, n_bins, 0.1), rand_words(c, n_bins, 0.1)
    valid = np.ones(c, np.int32)
    dropped = [0, 7, 13, 39]
    valid[dropped] = 0
    got = ops.sketch_topk(t(a), t(b), n_bins, "jaccard", k=6,
                          b_valid=torch.from_numpy(valid))
    want = jops.sketch_topk(jnp.asarray(a), jnp.asarray(b), n_bins=n_bins,
                            measure="jaccard", k=6, b_valid=jnp.asarray(valid))
    s = np.asarray(jops.sketch_score(jnp.asarray(a), jnp.asarray(b), n_bins=n_bins,
                                     measure="jaccard"))
    assert not np.isin(got[1].numpy(), dropped).any()
    assert_topk_equivalent((got[0].numpy(), got[1].numpy()), want, truth_rows(s))


@pytest.mark.parametrize("q,c,n_bins,k", [(1, 1, 32, 1), (130, 300, 1000, 3),
                                          (3, 5000, 200, 8), (2, 3, 64, 5)])
def test_sketch_topk_is_sorted_score(q, c, n_bins, k):
    """Against the sorted score matrix under the (score desc, id asc) order,
    including a corpus past the plain version's 4096-row chunk."""
    a, b = t(rand_words(q, n_bins, 0.1)), t(rand_words(c, n_bins, 0.1))
    sc, ix = ops.sketch_topk(a, b, n_bins, "jaccard", k=k)
    s = ops.sketch_score(a, b, n_bins, "jaccard").numpy()
    order = np.lexsort((np.broadcast_to(np.arange(c), s.shape), -s), axis=1)[:, :k]
    kk = min(k, c)
    np.testing.assert_array_equal(ix.numpy()[:, :kk], order[:, :kk])
    np.testing.assert_array_equal(sc.numpy()[:, :kk], np.take_along_axis(s, order, 1)[:, :kk])
    assert (ix.numpy()[:, kk:] == -1).all()


def test_sketch_topk_counts_ties_to_lower_id():
    """Counts tie often: ids must follow the lowest-id-first order exactly."""
    a, b = rand_words(6, 200, 0.05), rand_words(64, 200, 0.05)
    sc, ix = ops.sketch_topk(t(a), t(b), 1, "counts", k=8)
    s = np.asarray(jref.score_counts_ref(jnp.asarray(a), jnp.asarray(b)), np.float32)
    order = np.lexsort((np.broadcast_to(np.arange(64), s.shape), -s), axis=1)[:, :8]
    np.testing.assert_array_equal(ix.numpy(), order)
    np.testing.assert_array_equal(sc.numpy(), np.take_along_axis(s, order, 1))


def test_sketch_topk_empty_corpus_and_all_masked():
    a = t(rand_words(3, 64))
    sc, ix = ops.sketch_topk(a, t(np.zeros((0, 2), np.uint32)), 64, k=4)
    assert sc.shape == (3, 4) and (sc == -np.inf).all() and (ix == -1).all()
    sc, ix = ops.sketch_topk(a, t(rand_words(5, 64)), 64, k=4,
                             b_valid=torch.zeros(5, dtype=torch.int32))
    assert (sc == -np.inf).all() and (ix == -1).all()


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launches()
    a = t(rand_words(3, 64))
    ops.sketch_score(a, a, 64)
    ops.sketch_topk(a, a, 64, k=2)
    ops.build_sketch(torch.zeros((2, 3), dtype=torch.int32), 64)
    ops.band_hash(a, 2)
    ops.hash_build_sketch(torch.zeros((2, 3), dtype=torch.int32), torch.tensor([3, 5]), 64)
    assert ops.launches == {"build_sketch": 0, "sketch_score": 0, "sketch_topk": 0,
                            "count_bins": 0, "rebucket": 0, "band_hash": 0, "hash_build": 0}


# ---------------------------------------------------- tensor-core launch plan
@pytest.mark.parametrize("w", [1, 5, 16, 46, 92, 184, 1024])
@pytest.mark.parametrize("k_pad", [0] + [1 << i for i in range(9)])
def test_launch_plan_fits_shared_memory(k_pad, w):
    """Every power-of-two k_pad <= 256 (0: the score kernel) at every W fits
    the 232,448 bytes a block may use, with a ring of at least three stages;
    as many 64-row warpgroups as the queries need (up to 4 for the score
    kernel, 2 for top-k) unless twice the warpgroups would not fit."""
    from repro_torch.hopper import popcount_sim as ps

    for q in (1, 64, 65, 129, 256, 1000):
        plan = ps.launch_plan(q, 300_000, w, k_pad, 132)
        assert plan.smem_bytes <= ps.SMEM_LIMIT == 232_448
        assert plan.smem_bytes == ps.smem_bytes(plan.warpgroups, plan.stages, k_pad,
                                                plan.stage_steps)
        assert 1 <= plan.stage_steps <= min(4, -(-w // 8))
        assert ps.MIN_STAGES <= plan.stages <= ps.MAX_STAGES
        need = min(2 if k_pad else 4, ps.next_pow2(-(-q // 64)))
        assert plan.warpgroups <= need
        if plan.warpgroups < need:
            assert ps.smem_bytes(2 * plan.warpgroups, ps.MIN_STAGES, k_pad) > ps.SMEM_LIMIT
    assert ps.launch_plan(256, 300_000, w, k_pad, 132).warpgroups == (
        4 if k_pad == 0 else 2 if k_pad <= 128 else 1)


@pytest.mark.parametrize("q,c", [(1, 1), (63, 255), (65, 257), (129, 511), (256, 300_000),
                                 (1000, 7), (300, 65_537)])
@pytest.mark.parametrize("k_pad", [0, 16, 256])
def test_launch_plan_covers_every_row_and_tile_once(q, c, k_pad):
    """The blocks' (query tile, corpus range) pairs cover every query row and
    every 128-row corpus tile exactly once, with no empty range, and the
    grid is about one block an SM."""
    from repro_torch.hopper import popcount_sim as ps

    plan = ps.launch_plan(q, c, 184, k_pad, 132)
    n_tiles = -(-c // 128)
    rows_a = 64 * plan.warpgroups
    assert plan.n_tiles == n_tiles and plan.q_tiles == -(-q // rows_a)
    seen = np.zeros((plan.q_tiles, n_tiles), np.int64)
    for y in range(plan.q_tiles):  # block (x, y), as the kernels take their work
        for x in range(plan.splits):
            t0 = x * plan.tiles_per_split
            t1 = min(t0 + plan.tiles_per_split, n_tiles)
            assert t0 < t1
            seen[y, t0:t1] += 1
    assert (seen == 1).all()  # every (query tile, corpus tile) once; every row in one tile
    assert plan.q_tiles * plan.splits < 132 + plan.q_tiles


@pytest.mark.parametrize("q,c,w,k_pad", [(0, 5, 8, 0), (5, 0, 8, 16), (5, 5, 0, 16),
                                         (5, 5, 8, 3), (5, 5, 8, 512), (5, 5, 8, -2),
                                         (65535 * 256 + 1, 5, 8, 16)])
def test_launch_plan_refuses_what_does_not_fit(q, c, w, k_pad):
    from repro_torch.hopper import popcount_sim as ps

    with pytest.raises(ValueError):
        ps.launch_plan(q, c, w, k_pad, 132)


def k256_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The score and top-k kernels' blocking of the word axis in plain
    PyTorch: counts summed over k256 steps of 8 words, each step's words >=
    W read as zero (the zero-fill of the copies into shared memory)."""
    q, w = a.shape
    steps = -(-w // 8)
    a8 = torch.nn.functional.pad(a, (0, steps * 8 - w)).reshape(q, steps, 8)
    b8 = torch.nn.functional.pad(b, (0, steps * 8 - w)).reshape(b.shape[0], steps, 8)
    out = torch.zeros((q, b.shape[0]), dtype=torch.int32)
    for s in range(steps):
        out += tpk.and_popcount_pairwise(a8[:, s], b8[:, s])
    return out


@pytest.mark.parametrize("w", [1, 5, 8, 9, 17, 46, 184])
def test_k256_blocking_matches_pairwise_counts(w):
    """The kernels' k256 blocking, emulated, gives the JAX package's
    ``and_popcount_pairwise`` bit for bit, on words with every bit pattern
    (the top bit and all-ones rows included)."""
    from repro.core import packed as jpk

    a = RNG.integers(0, 1 << 32, (7, w), dtype=np.uint64).astype(np.uint32)
    b = RNG.integers(0, 1 << 32, (13, w), dtype=np.uint64).astype(np.uint32)
    a[0] = 0xFFFFFFFF
    b[1] = 0xFFFFFFFF
    got = k256_counts(t(a), t(b))
    want = np.asarray(jpk.and_popcount_pairwise(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
