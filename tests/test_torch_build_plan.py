"""The warp-per-row bitmap build of ``sketch_build`` and ``hash_build``
(``csrc/bitmap_build.cuh``) on the CPU, where its kernel cannot run.

* The launch plan (``hopper/sketch_build.py::launch_plan``): shared bytes
  within the default 48 KB for every W up to ``MAX_WORDS``, every row taken by
  exactly one warp, 16-byte loads only from an aligned base.
* The reciprocal modulus of ``hash_build``: the kernel's arithmetic, emulated
  with Python integers, equals ``%`` on edge and random 32-bit values.
* The kernel's walk emulated in plain Python: each warp's aligned 16-byte
  windows over the flat buffer (or its 4-byte loads from a base that is not
  aligned), with head and tail masking, the map, the scatter. Held bit-exact
  to the JAX ``ops.build_sketch`` / ``ops.hash_build_sketch`` in Pallas
  interpret mode (bins < N) and to the port's plain versions, for P % 4 in
  {0, 1, 2, 3}, so that rows start at offsets that are not multiples of 4.
  The JAX side runs at one small shape per P: each compiles for seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import make_mapping as j_make_mapping
from repro.kernels import ops as jops
from repro_torch.convert import mapping_from_reference, packed_to_reference
from repro_torch.core import BinSketchConfig
from repro_torch.core import packed as pk
from repro_torch.hopper import hash_build, ref
from repro_torch.hopper import sketch_build as sb

U32, U64 = (1 << 32) - 1, (1 << 64) - 1
SMS = 132  # an H100's SMs
BASE = 1 << 20  # a 16-byte-aligned address of the emulated allocations


# ------------------------------------------------------------- launch plan
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 31, 184, 185, 1000, 4096, 12287, sb.MAX_WORDS])
def test_launch_plan_fits_default_shared_memory(w):
    """At every B the block's slices fit the 48 KB a kernel may use without
    opting in, one row or more a block; at MAX_WORDS exactly one row."""
    for b in (1, 3, 256, 16384):
        plan = sb.launch_plan(b, w, SMS, BASE, BASE)
        assert 1 <= plan.rows_per_block <= sb.MAX_ROWS_PER_BLOCK
        assert plan.smem_bytes == plan.rows_per_block * sb.slice_words(w) * 4
        assert plan.smem_bytes <= sb.SMEM_LIMIT == 48 * 1024
        assert sb.slice_words(w) % 4 == 0 and 0 <= sb.slice_words(w) - w < 4
    assert sb.launch_plan(16384, sb.MAX_WORDS, SMS, BASE, BASE).rows_per_block == 1


@pytest.mark.parametrize("b", [1, 3, 256, 16384])
@pytest.mark.parametrize("w", [3, 184, sb.MAX_WORDS])
def test_launch_plan_covers_every_row_once(b, w):
    """Warp j of block x takes row x * rows_per_block + j: every row exactly
    once, no block without a row; a 256-row query batch spreads over the
    132 SMs, and the ingest batch fills blocks of 8 rows at W = 184."""
    plan = sb.launch_plan(b, w, SMS, BASE, BASE)
    seen = np.zeros(b, np.int64)
    for x in range(plan.blocks):
        rows = [x * plan.rows_per_block + j for j in range(plan.rows_per_block)]
        assert rows[0] < b
        for r in rows:
            if r < b:
                seen[r] += 1
    assert (seen == 1).all()
    assert plan.blocks >= min(b, SMS)
    if (b, w) == (16384, 184):
        assert plan.rows_per_block == 8


@pytest.mark.parametrize("w", [184, 185])
def test_launch_plan_vec16_only_where_aligned(w):
    """16-byte loads only from a 16-byte-aligned base (an offset view, such as
    ``flat[1:]``, takes 4-byte loads); 16-byte stores only where W % 4 == 0
    and the output's base is aligned."""
    for off in range(0, 16, 4):
        plan = sb.launch_plan(256, w, SMS, BASE + off, BASE + off)
        assert plan.vec_in == int(off == 0)
        assert plan.vec_out == int(off == 0 and w % 4 == 0)


@pytest.mark.parametrize("b,w", [(0, 184), (5, 0), (5, sb.MAX_WORDS + 1)])
def test_launch_plan_refuses_what_does_not_fit(b, w):
    with pytest.raises(ValueError):
        sb.launch_plan(b, w, SMS, BASE, BASE)


# ------------------------------------------------------ reciprocal modulus
def fastmod(h: int, n: int) -> int:
    """The kernel's ``h mod N``: ``__umul64hi(recip * h, N)``, the product
    ``recip * h`` wrapping mod 2^64 as a 64-bit multiply does."""
    return (((hash_build.reciprocal(n) * h) & U64) * n) >> 64


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 1464, 2929, 5859, 2**31 - 1])
def test_reciprocal_modulus_equals_mod(n):
    rng = np.random.default_rng(n)
    hs = [0, 1, 2, n - 1, n, n + 1, 2 * n - 1, 2**31 - 1, 2**31, 2**32 - 2, U32,
          (U32 // n) * n, (U32 // n) * n - 1]
    hs += [int(x) for x in rng.integers(0, 1 << 32, 20_000, dtype=np.uint64)]
    for h in hs:
        h &= U32
        assert fastmod(h, n) == h % n, (h, n)
    assert hash_build.reciprocal(1) == 0


def test_reciprocal_refuses_n_outside_32_bits():
    for n in (0, 1 << 32):
        with pytest.raises(ValueError):
            hash_build.reciprocal(n)


# ------------------------------------------------- the kernel's walk, emulated
def range_map(n_bins):
    """RangeMap: the id's uint32 bits, kept if below N."""
    return lambda i: (i & U32, (i & U32) < n_bins)


def hash_map(coeffs: torch.Tensor, n_bins):
    """HashMap: (a, b) as the low 32 bits of the int64 pair the wrapper
    passes, the hash in uint32, the modulus by the reciprocal; i >= 0 only."""
    a, b = [int(c) & U32 for c in coeffs.to(torch.int64).tolist()]
    return lambda i: (fastmod((a * (i & U32) + b) & U32, n_bins), i >= 0)


def emulate_bitmap_build(flat: list, offset: int, b: int, p: int, n_bins: int, bin_of,
                         sms: int = 2) -> torch.Tensor:
    """``bitmap_build_kernel`` walked in plain Python over the ids ``flat[offset
    : offset + b*p]`` of a 16-byte-aligned allocation ``flat``: the launch
    plan for that base, then each block's warps and each warp's lanes,
    chunks of 8 groups a lane, 16-byte windows from the aligned span around
    the row (or 4-byte loads of the row's own positions), head and tail
    masked, every load checked to lie inside the view and, if 16 bytes wide,
    to be aligned. Returns the (b, W) int32 words."""
    w = pk.num_words(n_bins)
    plan = sb.launch_plan(b, w, sms, BASE + 4 * offset, BASE)
    total = b * p
    words = torch.zeros((b, sb.slice_words(w) * 32), dtype=torch.uint8)
    done = set()

    def ld4(q):
        assert 0 <= q < total
        return flat[offset + q]

    def ld16(q):
        assert 0 <= q and q + 4 <= total and (BASE + 4 * (offset + q)) % 16 == 0
        return [flat[offset + q + j] for j in range(4)]

    for x in range(plan.blocks):
        for warp in range(plan.rows_per_block):
            row = x * plan.rows_per_block + warp
            if row >= b:
                continue
            assert row not in done
            done.add(row)
            s = row * p
            head = s & 3 if plan.vec_in else 0
            e0 = s - head  # the kernel's base: 16-byte aligned where vec_in
            groups = (p + head + 3) // 4
            full = min(groups, (total - e0) // 4) if plan.vec_in else 0
            seen = []
            for g0 in range(0, groups, 32 * 8):
                for lane in range(32):
                    for k in range(8):
                        g = g0 + 32 * k + lane
                        r = 4 * g - head  # position in the row of the group's first id
                        if g < full:
                            vals = ld16(e0 + 4 * g)
                        else:
                            vals = [ld4(e0 + 4 * g + j) if 0 <= r + j < p else -1
                                    for j in range(4)]
                        for j, v in enumerate(vals):
                            if not 0 <= r + j < p:
                                continue
                            seen.append(e0 + 4 * g + j)
                            bin_, keep = bin_of(v)
                            if keep:
                                words[row, bin_] = 1
            assert sorted(seen) == list(range(s, s + p))  # each position of the row once
    assert len(done) == b
    assert not words[:, n_bins:].any()
    return pk.pack_bits(words)[:, :w]


def _flat_with_guards(ids: np.ndarray, offset: int, n_bins: int, rng) -> list:
    """The ids at element ``offset`` of a buffer whose other elements are
    valid bin ids: a read outside the view, or a mask that lets one
    through, would set bits."""
    total = ids.size
    flat = rng.integers(0, n_bins, offset + total + 7).tolist()
    flat[offset : offset + total] = ids.reshape(-1).tolist()
    return flat


@pytest.mark.parametrize("p", [12, 13, 14, 15])
def test_emulated_sketch_build_matches_jax_and_plain(p):
    """P % 4 in {0, 1, 2, 3} (rows starting at every offset mod 4), from an
    aligned base (16-byte windows) and from one 4 bytes past (4-byte loads);
    pads, negative ids and ids >= N in the ids given to the plain version and
    the emulation; bins < N only for the JAX kernel (ROADMAP queue 3)."""
    rng = np.random.default_rng(p)
    b, n_bins = 5, 100 if p % 2 else 70  # W = 4 (16-byte stores) and W = 3
    ids = rng.integers(0, n_bins, (b, p)).astype(np.int32)
    ids[rng.random((b, p)) < 0.2] = -1
    ids[0] = -1  # a row of pads only
    want = np.asarray(jops.build_sketch(jnp.asarray(ids), n_bins, interpret=True))
    wild = ids.copy()
    wild[1, ::3] = n_bins + 7  # ids >= N
    wild[2, ::4] = -(2**31)
    want_wild = packed_to_reference(ref.build_sketch_ref(torch.from_numpy(wild), n_bins))
    for offset in (0, 1, 3):
        got = emulate_bitmap_build(_flat_with_guards(wild, offset, n_bins, rng), offset, b, p,
                                   n_bins, range_map(n_bins))
        np.testing.assert_array_equal(packed_to_reference(got), want_wild)
        got = emulate_bitmap_build(_flat_with_guards(ids, offset, n_bins, rng), offset, b, p,
                                   n_bins, range_map(n_bins))
        np.testing.assert_array_equal(packed_to_reference(got), want)
    np.testing.assert_array_equal(
        packed_to_reference(ref.build_sketch_ref(torch.from_numpy(ids), n_bins)), want)


@pytest.mark.parametrize("p", [12, 13, 14, 15])
def test_emulated_hash_build_matches_jax_and_plain(p):
    """The same walk with the hash map, on the JAX package's coefficients
    passed as int64 and as int32 holding the uint32 bits, against JAX
    ``ops.hash_build_sketch`` in interpret mode and ``ref.hash_build_ref``;
    indices up to 2^31 - 1, negative ones as pads."""
    rng = np.random.default_rng(100 + p)
    b, n_bins = 5, 100 if p % 2 else 70
    jcfg = JCfg(d=1 << 30, n_bins=n_bins, mode="hash")
    jco = j_make_mapping(jcfg, jax.random.PRNGKey(p))
    co64 = mapping_from_reference(np.asarray(jco), BinSketchConfig(d=1 << 30, n_bins=n_bins,
                                                                   mode="hash"), "cpu")
    co32 = pk._to_int32_bits(co64)
    idx = rng.integers(0, 2**31 - 1, (b, p)).astype(np.int32)
    idx[rng.random((b, p)) < 0.2] = -1
    idx[0] = -1
    idx[1, 0] = 2**31 - 1
    idx[2, ::4] = -(2**31)
    want = np.asarray(jops.hash_build_sketch(jnp.asarray(idx), jco, n_bins, interpret=True))
    np.testing.assert_array_equal(
        packed_to_reference(ref.hash_build_ref(torch.from_numpy(idx), co64, n_bins)), want)
    for co in (co64, co32):
        for offset in (0, 1, 3):
            got = emulate_bitmap_build(_flat_with_guards(idx, offset, n_bins, rng), offset, b, p,
                                       n_bins, hash_map(co, n_bins))
            np.testing.assert_array_equal(packed_to_reference(got), want)


@pytest.mark.parametrize("p", [1, 2, 3, 1021, 1030, 2049])
def test_emulated_build_short_and_long_rows(p):
    """Rows shorter than one group, whose aligned windows would run past the
    buffer's end from rows before the last, and rows longer than one chunk
    of 8 groups a lane (1,024 ids), which the walk takes in several: each
    position read once, against the plain versions of both builds."""
    rng = np.random.default_rng(p)
    b, n_bins = 3, 517
    ids = rng.integers(-5, n_bins + 5, (b, p)).astype(np.int32)
    co = torch.tensor([0x9E3779B1, 0xDEADBEEF], dtype=torch.int64)
    for offset in (0, 1):
        flat = _flat_with_guards(ids, offset, n_bins, rng)
        got = emulate_bitmap_build(flat, offset, b, p, n_bins, range_map(n_bins))
        assert torch.equal(got, ref.build_sketch_ref(torch.from_numpy(ids), n_bins))
        got = emulate_bitmap_build(flat, offset, b, p, n_bins, hash_map(co, n_bins))
        assert torch.equal(got, ref.hash_build_ref(torch.from_numpy(ids), co, n_bins))
