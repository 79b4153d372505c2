"""Port parity, the paper's baselines: ``repro_torch.core.baselines`` held to
``repro.core.baselines`` on the CPU.

Each baseline draws its parameters in the JAX package (``make_mapping``,
``make_hashes``, ``make_params`` with ``PRNGKey(0)``); they pass into the port
as numpy, and both packages sketch the same numpy rows. Integer sketches must
be bit-equal (BCS and OddSketch words, MinHash values and sizes, DOPH's
densified values, SimHash bits). CBE's bits are equal except where the
float64 numpy projection lies within 1e-3·‖x‖ of 0, where the two float32
FFTs may round to either sign. Every estimator dict is allclose at rtol 1e-5
/ atol 1e-6.

Then each case of ``tests/test_baselines.py`` is replayed on the port with
the port's own draws and the same error bounds, and the edges that the
reference's loops cover and the port's closed forms must too: DOPH's
densification on empty bins, all-empty rows and a hash value equal to the
empty marker, and OddSketch's pair hash at full 32-bit width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import bcs, cbe, doph, minhash, oddsketch, simhash
from repro_torch.convert import packed_from_reference
from repro_torch.core import packed as tpk
from repro_torch.core.baselines import bcs as t_bcs
from repro_torch.core.baselines import cbe as t_cbe
from repro_torch.core.baselines import doph as t_doph
from repro_torch.core.baselines import minhash as t_minhash
from repro_torch.core.baselines import oddsketch as t_oddsketch
from repro_torch.core.baselines import simhash as t_simhash

D = 20000
KEY = jax.random.PRNGKey(0)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
N_BINS, K = 1024, 512  # BCS / OddSketch width; functions of MinHash, DOPH, SimHash, CBE
U32 = 0xFFFFFFFF


def _pad(rows, p):
    out = np.full((len(rows), p), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = np.sort(r)
    return out


def _rows(p=128, seed=0):
    """16 rows: 8 random sets and 8 near copies of them (so the estimates
    span low to high similarity), one empty row and one full row."""
    rng = np.random.default_rng(seed)
    base = [rng.choice(D, rng.integers(20, p), replace=False) for _ in range(8)]
    base[0] = np.array([], np.int64)  # an empty row
    base[1] = rng.choice(D, p, replace=False)  # a full row
    near = []
    for i, b in enumerate(base):
        keep = b[: len(b) - (len(b) * i) // 10]
        new = rng.choice(D, len(b) - len(keep), replace=False)
        near.append(np.unique(np.concatenate([keep, new]))[:p])
    return _pad(base + near, p)


ROWS = _rows()
A, B = slice(0, 8), slice(8, 16)


def _u32(x) -> torch.Tensor:
    """Reference uint32 values as the port's int64 tensor."""
    return torch.from_numpy(np.array(x).astype(np.uint32).astype(np.int64))


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _sketched(name):
    """(reference sketch, port sketch, reference estimates, port estimates) of
    ROWS under the reference's PRNGKey(0) draws, rows A against rows B."""
    j_idx, t_idx = jnp.asarray(ROWS), torch.from_numpy(ROWS)
    if name == "bcs":
        m = bcs.make_mapping(D, N_BINS, KEY)
        js = bcs.sketch_indices(m, N_BINS, j_idx)
        ts = t_bcs.sketch_indices(torch.from_numpy(np.array(m)), N_BINS, t_idx)
        return (js, ts, bcs.estimates(js[A], js[B], N_BINS),
                t_bcs.estimates(ts[A], ts[B], N_BINS))
    if name in ("minhash", "doph"):
        mod, tmod = (minhash, t_minhash) if name == "minhash" else (doph, t_doph)
        h = minhash.make_hashes(K, KEY) if name == "minhash" else doph.make_hashes(KEY)
        args = () if name == "minhash" else (K,)
        (jv, jsz), (tv, tsz) = (mod.sketch_indices(h, *args, j_idx),
                                tmod.sketch_indices(_u32(h), *args, t_idx))
        return ((jv, jsz), (tv, tsz), mod.estimates(jv[A], jv[B], jsz[A], jsz[B]),
                tmod.estimates(tv[A], tv[B], tsz[A], tsz[B]))
    if name == "oddsketch":
        k = oddsketch.suggested_k(N_BINS, 0.9)
        h = oddsketch.make_hashes(k, KEY)
        js = oddsketch.sketch_indices(h, N_BINS, j_idx)
        ts = t_oddsketch.sketch_indices((_u32(h[0]), _u32(h[1])), N_BINS, t_idx)
        return (js, ts, oddsketch.estimates(js[A], js[B], N_BINS, k),
                t_oddsketch.estimates(ts[A], ts[B], N_BINS, k))
    if name == "simhash":
        h = simhash.make_hashes(K, KEY)
        js, ts = simhash.sketch_indices(h, j_idx), t_simhash.sketch_indices(_u32(h), t_idx)
        return js, ts, simhash.estimates(js[A], js[B]), t_simhash.estimates(ts[A], ts[B])
    assert name == "cbe"
    p = cbe.make_params(D, KEY)
    tp = (torch.from_numpy(np.array(p[0])), torch.from_numpy(np.array(p[1])))
    js = cbe.sketch_indices(p, K, D, j_idx)
    ts = t_cbe.sketch_indices(tp, K, D, t_idx)
    return js, ts, cbe.estimates(js[A], js[B]), t_cbe.estimates(ts[A], ts[B])


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("name", ["bcs", "minhash", "doph", "oddsketch", "simhash"])
def test_integer_sketch_bit_equal_to_reference(name):
    want, got, _, _ = _sketched(name)
    if name in ("bcs", "oddsketch"):  # packed words
        assert torch.equal(got, packed_from_reference(np.asarray(want), CPU))
    elif name == "simhash":  # sign bits
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), np.asarray(want))
    else:  # hash values and exact sizes
        assert torch.equal(got[0], _u32(want[0])) and got[0].dtype == torch.int64
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    if name == "doph":
        assert not (got[0] == U32).any(), "densification left empty bins"


def test_cbe_bits_equal_off_the_rounding_band():
    """CBE's bits against the float64 numpy projection: equal wherever it is
    more than 1e-3·‖x‖ from 0 (few lanes of a non-empty row are not)."""
    want, got, _, _ = _sketched("cbe")
    p = cbe.make_params(D, KEY)
    r_hat, signs = np.asarray(p[0]).astype(np.complex128), np.asarray(p[1]).astype(np.float64)
    dense = np.zeros((len(ROWS), D))
    for i, r in enumerate(ROWS):
        dense[i, r[r >= 0]] = 1.0
    y = np.fft.irfft(np.fft.rfft(dense * signs, axis=1) * r_hat, n=D, axis=1)[:, :K]
    norm = np.sqrt(dense.sum(1, keepdims=True))
    clear = np.abs(y) > 1e-3 * norm
    assert clear[norm[:, 0] > 0].mean() > 0.99  # empty rows project to 0 exactly
    assert np.array_equal(got.numpy()[clear], np.asarray(want)[clear])
    assert np.array_equal(got.numpy()[clear], (y >= 0)[clear].astype(np.uint8))


@pytest.mark.parametrize("name", ["bcs", "minhash", "doph", "oddsketch", "simhash", "cbe"])
def test_estimates_allclose_to_reference(name):
    _, _, want, got = _sketched(name)
    _close(got, want)


# ------------------------------------------------- DOPH and OddSketch edges
def test_doph_densify_matches_the_reference_scans():
    """Empty bins, a row with one full bin at either end, all-empty rows:
    the closed form equals the reference's two cyclic scans, bit for bit."""
    rng = np.random.default_rng(3)
    for k in (7, 64):
        bins = rng.integers(0, 2**32 - 1, (12, k), dtype=np.uint64)
        bins[rng.random((12, k)) < 0.6] = U32
        bins[0] = U32  # all empty
        bins[1] = U32
        bins[1, 0] = 5  # one full bin at the left end
        bins[2] = U32
        bins[2, k - 1] = 2**32 - 2  # one full bin at the right end
        bins[3] = U32
        bins[3, k // 2] = 0
        want = np.asarray(doph._densify(jnp.asarray(bins.astype(np.uint32))))
        got = t_doph.densify(torch.from_numpy(bins.astype(np.int64)))
        assert torch.equal(got, _u32(want)), f"k={k}"


def test_doph_planted_empty_marker_hash_counts_as_empty():
    """A value hash equal to 0xFFFFFFFF leaves its bin empty in the
    reference; the port densifies it the same way."""
    x0 = 12345
    a1, b1, a2 = 0x9E3779B1, 7, 0x85EBCA6B
    b2 = (U32 - a2 * x0) % 2**32  # (a2 * x0 + b2) mod 2^32 == 0xFFFFFFFF
    h = np.array([a1, b1, a2, b2], np.uint32)
    rows = _pad([[x0], [x0, 3, 40, 500], [], [1, 2, 3]], 8)
    jv, jsz = doph.sketch_indices(jnp.asarray(h), 16, jnp.asarray(rows))
    tv, tsz = t_doph.sketch_indices(_u32(h), 16, torch.from_numpy(rows))
    assert torch.equal(tv, _u32(jv)) and np.array_equal(tsz.numpy(), np.asarray(jsz))
    # row 0 holds only the planted element: every bin is densified from nothing
    assert torch.equal(tv[0], tv[2])


def test_oddsketch_full_width_pair_hash():
    """Coefficients and min-hash values near 2^32: the pair hash's product
    reaches 2^64, past int64, and must still wrap as uint32."""
    k = 64
    mh = np.stack([U32 - 2 * np.arange(k), U32 - np.arange(k)]).astype(np.uint32)
    pair = np.array([U32, U32 - 1], np.uint32)
    rows = _pad([[0, 1], [5], [19999, 1, 77], []], 4)
    want = oddsketch.sketch_indices((jnp.asarray(mh), jnp.asarray(pair)), 97,
                                    jnp.asarray(rows))
    got = t_oddsketch.sketch_indices((_u32(mh), _u32(pair)), 97, torch.from_numpy(rows))
    assert torch.equal(got, packed_from_reference(np.asarray(want), CPU))
    # mul_u32 against numpy's wrapping uint32 product, extremes included
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.integers(0, 2**32, 200, dtype=np.uint64), [0, 1, U32, U32 - 1]])
    c = np.concatenate([rng.integers(0, 2**32, 200, dtype=np.uint64), [U32, U32, U32, 1]])
    with np.errstate(over="ignore"):
        prod = x.astype(np.uint32) * c.astype(np.uint32)
    got = tpk.mul_u32(torch.from_numpy(x.astype(np.int64)), torch.from_numpy(c.astype(np.int64)))
    assert np.array_equal(got.numpy(), prod.astype(np.int64))


# ------------------------------- tests/test_baselines.py, on the port's draws
def _pair(n_common, n_a, n_b, seed=0, pad=256):
    rng = np.random.default_rng(seed)
    words = rng.choice(D, n_common + n_a + n_b, replace=False)
    a = np.concatenate([words[:n_common], words[n_common : n_common + n_a]])
    b = np.concatenate([words[:n_common], words[n_common + n_a :]])
    padf = lambda v: np.concatenate([v, -np.ones(pad - len(v), np.int32)]).astype(np.int32)  # noqa: E731
    return torch.from_numpy(np.stack([padf(a), padf(b)]))


IDX = _pair(120, 40, 60)
IP_T, SA, SB = 120, 160, 180
JS_T = IP_T / (SA + SB - IP_T)
COS_T = IP_T / np.sqrt(SA * SB)


def test_bcs_estimates():
    n_bins = 4096
    m = t_bcs.make_mapping(D, n_bins, device=CPU)
    sk = t_bcs.sketch_indices(m, n_bins, IDX)
    e = t_bcs.estimates(sk[:1], sk[1:], n_bins)
    assert abs(float(e["ip"][0]) - IP_T) < 25
    assert abs(float(e["jaccard"][0]) - JS_T) < 0.1
    # XOR-linearity: sketch(a) ^ sketch(b) == sketch of symmetric difference
    a, b = IDX[0].numpy(), IDX[1].numpy()
    sym = np.concatenate([a[(a >= 0) & ~np.isin(a, b)], b[(b >= 0) & ~np.isin(b, a)]])
    pad = np.full((1, IDX.shape[1]), -1, np.int32)
    pad[0, : len(sym)] = sym
    sk_sym = t_bcs.sketch_indices(m, n_bins, torch.from_numpy(pad))
    assert torch.equal(sk_sym[0], sk[0] ^ sk[1])


def test_minhash_estimates():
    h = t_minhash.make_hashes(1024, device=CPU)
    mh, sizes = t_minhash.sketch_indices(h, IDX)
    assert sizes.tolist() == [SA, SB]
    e = t_minhash.estimates(mh[:1], mh[1:], sizes[:1], sizes[1:])
    assert abs(float(e["jaccard"][0]) - JS_T) < 0.06
    assert abs(float(e["cosine"][0]) - COS_T) < 0.08


def test_doph_estimates():
    h = t_doph.make_hashes(device=CPU)
    vals, sizes = t_doph.sketch_indices(h, 1024, IDX)
    assert not (vals == U32).any(), "densification left empty bins"
    e = t_doph.estimates(vals[:1], vals[1:], sizes[:1], sizes[1:])
    assert abs(float(e["jaccard"][0]) - JS_T) < 0.12


def test_simhash_and_cbe_cosine():
    h = t_simhash.make_hashes(2048, device=CPU)
    bits = t_simhash.sketch_indices(h, IDX)
    e = t_simhash.estimates(bits[:1], bits[1:])
    assert abs(float(e["cosine"][0]) - COS_T) < 0.08

    p = t_cbe.make_params(D, device=CPU)
    cb = t_cbe.sketch_indices(p, 2048, D, IDX)
    e2 = t_cbe.estimates(cb[:1], cb[1:])
    # circulant projections are correlated: looser tolerance (paper Fig.2
    # shows CBE's accuracy below SimHash at equal N)
    assert abs(float(e2["cosine"][0]) - COS_T) < 0.2


def test_oddsketch_high_similarity():
    # OddSketch targets HIGH similarity: use a 0.9-Jaccard pair
    idx = _pair(190, 10, 11, seed=2)
    js_t = 190 / (200 + 201 - 190)
    n_bins = 2048
    k = t_oddsketch.suggested_k(n_bins, js_t)
    assert k == oddsketch.suggested_k(n_bins, js_t)
    h = t_oddsketch.make_hashes(k, device=CPU)
    sk = t_oddsketch.sketch_indices(h, n_bins, idx)
    e = t_oddsketch.estimates(sk[:1], sk[1:], n_bins, k)
    assert abs(float(e["jaccard"][0]) - js_t) < 0.08


@pytest.mark.parametrize("make", [
    lambda: t_bcs.make_mapping(D, 64, seed=5, device=CPU),
    lambda: t_minhash.make_hashes(8, seed=5, device=CPU),
    lambda: t_doph.make_hashes(seed=5, device=CPU),
    lambda: t_oddsketch.make_hashes(8, seed=5, device=CPU),
    lambda: t_simhash.make_hashes(8, seed=5, device=CPU),
    lambda: t_cbe.make_params(64, seed=5, device=CPU),
], ids=["bcs", "minhash", "doph", "oddsketch", "simhash", "cbe"])
def test_draws_are_seeded(make):
    """One seed, one set of parameters; multiply-shift multipliers odd and
    every coefficient a uint32 value."""
    one, two = make(), make()
    one = one if isinstance(one, tuple) else (one,)
    two = two if isinstance(two, tuple) else (two,)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    for t in one:
        if t.dtype == torch.int64:
            assert int(t.min()) >= 0 and int(t.max()) <= U32
    if len(one) == 2 and one[0].dtype == torch.int64:  # OddSketch: both multipliers odd
        assert bool((one[0][0] & 1).all()) and int(one[1][0]) & 1
