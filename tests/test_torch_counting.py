"""Port parity, counting core and the two mutable-path kernels: ``core/counting``,
``packed.segment_or`` / ``fold_packed`` / ``or_rows``, ``ops.count_bins`` and
``ops.rebucket`` on CPU tensors (their plain versions), and the distillation
worker's host fold — the same numpy inputs through ``repro`` (JAX, CPU; Pallas
in interpret mode at tiny shapes) and ``repro_torch`` (device="cpu").

Every output here is integer (counters, packed words, fills), so every check
is bit-equal. The reference keeps u16 counters; the port's are int32 clamped
at the same 65535, so equal values compare equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import counting as jcount
from repro.core import make_mapping as j_make_mapping
from repro.core import packed as jpk
from repro.engine import segments as jseg
from repro.kernels import ops as jops
from repro_torch.convert import (
    config_from_reference,
    mapping_from_reference,
    packed_from_reference,
    packed_to_reference,
)
from repro_torch.core import counting as tcount
from repro_torch.core import packed as tpk
from repro_torch.engine import get_backend
from repro_torch.engine import segments as tseg
from repro_torch.hopper import ops

RNG = np.random.default_rng(23)
CPU = "cpu"


def rand_words(n, n_bins, tail_garbage=False):
    """(n, ceil(N/32)) uint32 words; bits >= N are zero unless asked for."""
    w = (n_bins + 31) // 32
    x = RNG.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    if n_bins % 32 and not tail_garbage:
        x[:, -1] &= np.uint32((1 << (n_bins % 32)) - 1)
    return x


def rand_rows(b, p, d, dup=True):
    """Padded sparse rows in [0, d), pad -1, with repeats when ``dup``."""
    out = np.full((b, p), -1, np.int32)
    for i, ln in enumerate(RNG.integers(0, p + 1, b)):
        v = RNG.integers(0, d, ln)
        if dup and ln > 1:
            v[: ln // 3] = v[-1]
        out[i, :ln] = RNG.permutation(v)
    return out


def t(x):
    return packed_from_reference(x, CPU)


def ti(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


@pytest.fixture(scope="module")
def maps():
    """(jax cfg, jax mapping, port cfg, port mapping) per Ψ mode, N=300."""
    out = {}
    for mode in ("table", "hash"):
        jcfg = JCfg(d=2048, n_bins=300, mode=mode)
        jmap = j_make_mapping(jcfg, jax.random.PRNGKey(1))
        tcfg = config_from_reference(jcfg.d, jcfg.n_bins, mode)
        out[mode] = (jcfg, jmap, tcfg, mapping_from_reference(np.asarray(jmap), tcfg, CPU))
    return out


# ----------------------------------------------------------------- counting
def test_dedup_padded_matches_reference():
    rows = rand_rows(9, 20, 12)
    rows[3] = -1  # a row of pads only
    got = tcount.dedup_padded(ti(rows)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcount.dedup_padded(jnp.asarray(rows))))
    assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in got)


@pytest.mark.parametrize("mode", ["table", "hash"])
def test_count_pack_and_fills_match_reference(maps, mode):
    """Occupancy, its ``> 0`` pack and its fills, bit-equal; the pack is the
    binary sketch."""
    jcfg, jmap, tcfg, tmap = maps[mode]
    rows = rand_rows(11, 40, jcfg.d)
    want = np.asarray(jcount.count_indices_dense(jcfg, jmap, jnp.asarray(rows)))
    got = tcount.count_indices_dense(tcfg, tmap, ti(rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(get_backend("reference").count(tcfg, tmap, ti(rows)).numpy(),
                                  want)
    np.testing.assert_array_equal(get_backend("cuda").count(tcfg, tmap, ti(rows)).numpy(), want)
    packed = tcount.counters_to_packed(got)
    np.testing.assert_array_equal(packed_to_reference(packed),
                                  np.asarray(jcount.counters_to_packed(jnp.asarray(want))))
    np.testing.assert_array_equal(packed, get_backend("reference").sketch(tcfg, tmap, ti(rows)))
    np.testing.assert_array_equal(tcount.counter_fills(got).numpy(),
                                  np.asarray(jcount.counter_fills(jnp.asarray(want))))


@pytest.mark.parametrize("n_new", [150, 64, 7, 300])
def test_fold_and_unfold_counters_match_reference(n_new):
    counts = RNG.integers(0, 4, (6, 300)).astype(np.int32)
    counts[0, ::2] = 65535  # saturating sums clamp, never wrap
    want = jcount.fold_counters(jnp.asarray(counts.astype(np.uint16)), n_new)
    got = tcount.fold_counters(ti(counts), n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert int(got.max()) <= tcount.COUNTER_MAX == jcount.COUNTER_MAX
    # the counter fold commutes with ``> 0`` and the packed fold
    np.testing.assert_array_equal(
        tcount.counters_to_packed(got),
        tpk.fold_packed(tcount.counters_to_packed(ti(counts)), 300, n_new))
    with pytest.raises(ValueError):
        tcount.fold_counters(ti(counts), 301)
    words = rand_words(5, 300)
    np.testing.assert_array_equal(tcount.packed_to_counters(t(words), 300).numpy(),
                                  np.asarray(jcount.packed_to_counters(jnp.asarray(words), 300)))


# ------------------------------------------------------------ packed, rest
def test_segment_or_matches_reference():
    data = rand_words(13, 200)
    seg = RNG.integers(0, 7, 13)
    seg[seg == 4] = 5  # segment 4 stays empty: an all-zero row
    want = jpk.segment_or(jnp.asarray(data), jnp.asarray(seg), 8)
    got = tpk.segment_or(t(data), torch.from_numpy(seg), 8)
    np.testing.assert_array_equal(packed_to_reference(got), np.asarray(want))
    assert tpk.segment_or(t(data[:0]), torch.zeros(0, dtype=torch.int64), 3).shape == (3, 7)


@pytest.mark.parametrize("n_bins,n_new", [(512, 100), (101, 33), (96, 96), (424, 1)])
def test_fold_packed_matches_reference(n_bins, n_new):
    x = rand_words(9, n_bins)
    got = tpk.fold_packed(t(x), n_bins, n_new)
    np.testing.assert_array_equal(packed_to_reference(got),
                                  np.asarray(jpk.fold_packed(jnp.asarray(x), n_bins, n_new)))


def test_or_rows_matches_reference():
    x = rand_words(6, 100).reshape(2, 3, 4)
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(packed_to_reference(tpk.or_rows(t(x), axis)),
                                      np.asarray(jpk.or_rows(jnp.asarray(x), axis)))
    assert torch.equal(tpk.or_rows(t(x[:0]), 0), torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tpk.fold_packed(t(x[0]), 64, 128)


# -------------------------------------------------------------- count_bins
@pytest.mark.parametrize("b,p,n_bins", [(13, 33, 517), (8, 10, 100), (3, 5, 1)])
def test_count_bins_matches_pallas(b, p, n_bins):
    """Ragged rows (nothing divides a block), an all-pad row, bins >= N."""
    bins = RNG.integers(-1, n_bins + 20, (b, p)).astype(np.int32)
    bins[1] = -1
    got = ops.count_bins(ti(bins), n_bins)
    want = jops.count_bins(jnp.asarray(bins), n_bins, interpret=True)
    assert got.dtype == torch.int32 and got.shape == (b, n_bins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,p,n_bins", [(4, 300, 70_000), (16, 870, 5859), (0, 8, 64)])
def test_count_bins_matches_oracle(b, p, n_bins):
    """Against the scatter-add oracle under an identity map, including an N
    wider than one kernel tile (70,000) and the ingest row width."""
    jcfg = JCfg(d=n_bins, n_bins=n_bins)
    rows = rand_rows(b, p, n_bins)
    want = jcount.count_indices_dense(jcfg, jnp.arange(n_bins, dtype=jnp.int32),
                                      jnp.asarray(rows))
    np.testing.assert_array_equal(ops.count_bins(ti(rows), n_bins).numpy(), np.asarray(want))


def test_count_bins_rejects_bad_input():
    with pytest.raises(TypeError):
        ops.count_bins(torch.zeros((2, 3), dtype=torch.int64), 8)


# ---------------------------------------------------------------- rebucket
REBUCKET_CASES = [(512, 256), (512, 100), (101, 33), (300, 7), (33, 32), (517, 1),
                  (517, 32), (64, 1), (5859, 1464)]


@pytest.mark.parametrize("n_bins,n_new", REBUCKET_CASES)
def test_rebucket_matches_reference(n_bins, n_new):
    """Against the reference's fold (its numpy twin, which the jnp fold
    matches above) and, for three cases, the Pallas wrapper in interpret
    mode: N' that does not divide N, N and N' not multiples of 32, N' = 1."""
    x = rand_words(13, n_bins)
    got = packed_to_reference(ops.rebucket(t(x), n_bins, n_new))
    np.testing.assert_array_equal(got, jseg._fold_packed_host(x, n_bins, n_new)[0])
    if (n_bins, n_new) in [(512, 100), (101, 33), (33, 32)]:
        np.testing.assert_array_equal(
            got, np.asarray(jops.rebucket(jnp.asarray(x), n_bins, n_new, interpret=True)))
    np.testing.assert_array_equal(
        packed_to_reference(get_backend("reference").rebucket(t(x), n_bins, n_new)), got)


def test_rebucket_contract():
    x = t(rand_words(4, 101))
    with pytest.raises(TypeError):
        ops.rebucket(x.to(torch.int64), 101, 50)
    with pytest.raises(ValueError, match="n_bins_new"):
        ops.rebucket(x, 101, 102)
    with pytest.raises(ValueError, match="n_bins_new"):
        ops.rebucket(x, 101, 0)
    assert ops.rebucket(x, 101, 101) is x  # the same width launches nothing
    # source bits >= N in the last word are ignored
    dirty = rand_words(4, 101, tail_garbage=True)
    clean = dirty.copy()
    clean[:, -1] &= np.uint32((1 << 5) - 1)
    assert torch.equal(ops.rebucket(t(dirty), 101, 33), ops.rebucket(t(clean), 101, 33))
    assert ops.rebucket(t(dirty[:0]), 101, 33).shape == (0, 2)


@pytest.mark.parametrize("n_bins,n_new", [(424, 212), (5859, 2929), (101, 33), (300, 7)])
def test_fold_packed_host_matches_reference_and_kernel(n_bins, n_new):
    """The distillation worker's numpy fold, the port's copy against the
    reference's; the distilled rows come from it and the queries that meet
    them from ``ops.rebucket``, so the two must give the same words."""
    x = rand_words(17, n_bins)
    got_w, got_f = tseg._fold_packed_host(x, n_bins, n_new)
    want_w, want_f = jseg._fold_packed_host(x, n_bins, n_new)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_w, packed_to_reference(ops.rebucket(t(x), n_bins, n_new)))
    np.testing.assert_array_equal(got_f, tpk.row_popcount(t(got_w)).numpy())


def test_cpu_calls_of_the_new_wrappers_do_not_count():
    ops.reset_launches()
    ops.count_bins(torch.zeros((2, 3), dtype=torch.int32), 64)
    ops.rebucket(t(rand_words(2, 64)), 64, 32)
    assert ops.launches["count_bins"] == ops.launches["rebucket"] == 0
