"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card every test here skips (the kernels have no
interpret mode). On a machine with one:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Build bit-exact; score counts exact and measures within rtol 1e-5 / atol
1e-6 (kernel and plain version share the epilogue's table and fused
multiply-adds); top-k ids equal to the plain version's wherever the scores
do not tie.
"""

import pytest
import torch

from repro_torch.core import packed as pk
from repro_torch.hopper import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda", 0)


def _words(gen, rows, n_bins, density, dev):
    bits = torch.rand((rows, pk.num_words(n_bins) * 32), generator=gen, device=dev) < density
    bits[:, n_bins:] = False
    return pk.pack_bits(bits.to(torch.uint8))


@pytest.mark.parametrize("b,p,n_bins", [(1, 4, 32), (7, 33, 517), (300, 870, 6017)])
def test_build_sketch_kernel(dev, b, p, n_bins):
    gen = torch.Generator(device=dev).manual_seed(b)
    bins = torch.randint(-1, n_bins + 40, (b, p), generator=gen, device=dev, dtype=torch.int32)
    before = ops.launches["build_sketch"]
    got = ops.build_sketch(bins, n_bins)
    assert ops.launches["build_sketch"] == before + 1
    assert torch.equal(got, ref.build_sketch_ref(bins, n_bins))


@pytest.mark.parametrize("q,c,n_bins", [(9, 130, 517), (256, 5000, 6017)])
@pytest.mark.parametrize("measure", ref.MEASURES)
def test_score_and_topk_kernels(dev, q, c, n_bins, measure):
    gen = torch.Generator(device=dev).manual_seed(q)
    a, b = _words(gen, q, n_bins, 0.04, dev), _words(gen, c, n_bins, 0.04, dev)
    got, want = ops.sketch_score(a, b, n_bins, measure), ref.sketch_score_ref(a, b, n_bins, measure)
    if measure == "counts":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    valid = (torch.rand(c, generator=gen, device=dev) > 0.1).to(torch.int32)
    for k in (1, 10, 100):
        sc, ix = ops.sketch_topk(a, b, n_bins, measure, k=k, b_valid=valid)
        ws, wi = ref.sketch_topk_ref(a, b, n_bins, measure, k=k, b_valid=valid)
        torch.testing.assert_close(sc, ws, rtol=1e-5, atol=1e-6)
        differ = ix != wi
        if differ.any():  # only where the two ids' scores tie
            r = differ.nonzero(as_tuple=True)[0]
            torch.testing.assert_close(want[r, ix[differ].long()], want[r, wi[differ].long()],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q,c,w", [(1, 100, 1), (63, 255, 5), (65, 257, 9), (129, 511, 17),
                                   (1, 513, 46), (63, 769, 9), (129, 1025, 46), (65, 1023, 17)])
def test_score_and_topk_ragged_tiles(dev, q, c, w):
    """Where the tensor-core tile is ragged: W not a multiple of its 8-word
    k256 step, Q around its 64-row warpgroups, C below two 128-row tiles or
    one past or short of a multiple of one, a mask that drops whole tiles,
    and k up to 256 (64-query blocks)."""
    gen = torch.Generator(device=dev).manual_seed(q * 1000 + w)
    n_bins = 32 * w - 5 if w > 1 else 20
    a, b = _words(gen, q, n_bins, 0.1, dev), _words(gen, c, n_bins, 0.1, dev)
    counts = ops.sketch_score(a, b, n_bins, "counts")
    assert torch.equal(counts, ref.sketch_score_ref(a, b, n_bins, "counts"))
    want = ref.sketch_score_ref(a, b, n_bins, "jaccard")
    torch.testing.assert_close(ops.sketch_score(a, b, n_bins, "jaccard"), want,
                               rtol=1e-5, atol=1e-6)
    valid = (torch.rand(c, generator=gen, device=dev) > 0.2).to(torch.int32)
    valid[256:512] = 0
    for k in (1, 10, 256):
        sc, ix = ops.sketch_topk(a, b, n_bins, "jaccard", k=k, b_valid=valid)
        ws, wi = ref.sketch_topk_ref(a, b, n_bins, "jaccard", k=k, b_valid=valid)
        torch.testing.assert_close(sc, ws, rtol=1e-5, atol=1e-6)
        assert torch.equal(ix[~torch.isfinite(ws)], wi[~torch.isfinite(ws)])
        differ = (ix != wi) & torch.isfinite(ws)
        if differ.any():  # only where the two ids' scores tie
            r = differ.nonzero(as_tuple=True)[0]
            torch.testing.assert_close(want[r, ix[differ].long()], want[r, wi[differ].long()],
                                       rtol=1e-5, atol=1e-6)
        assert not torch.isin(ix, torch.arange(256, 512, device=dev, dtype=ix.dtype)).any()


@pytest.mark.parametrize("b,p,n_bins", [(16384, 870, 5859), (7, 33, 517), (300, 1000, 70_000),
                                        (1, 4, 32)])
def test_count_bins_kernel(dev, b, p, n_bins):
    """The ingest shape of the mutable path (NYTimes at rho 0.05: N=5859),
    an N wider than one kernel tile, ids >= N and rows of pads only."""
    gen = torch.Generator(device=dev).manual_seed(p)
    bins = torch.randint(-1, n_bins + 40, (b, p), generator=gen, device=dev, dtype=torch.int32)
    bins[0] = -1
    before = ops.launches["count_bins"]
    got = ops.count_bins(bins, n_bins)
    assert ops.launches["count_bins"] == before + 1
    assert torch.equal(got, ref.count_bins_ref(bins, n_bins))


@pytest.mark.parametrize("b,n_bins,n_new", [(256, 5859, 2929), (256, 5859, 1464),
                                            (13, 512, 100), (9, 101, 33), (5, 517, 1),
                                            (5, 517, 32), (3, 33, 32)])
def test_rebucket_kernel(dev, b, n_bins, n_new):
    """A query chunk folded to the mutable path's distilled widths, and N'
    that does not divide N, N' = 1 and 32, N not a multiple of 32; source
    bits >= N are set and must not leak into the fold."""
    gen = torch.Generator(device=dev).manual_seed(n_new)
    bits = torch.rand((b, pk.num_words(n_bins) * 32), generator=gen, device=dev) < 0.3
    words = pk.pack_bits(bits.to(torch.uint8))
    before = ops.launches["rebucket"]
    got = ops.rebucket(words, n_bins, n_new)
    assert ops.launches["rebucket"] == before + 1
    assert torch.equal(got, ref.rebucket_ref(words, n_bins, n_new))
    assert torch.equal(got, pk.fold_packed(words, n_bins, n_new))
    assert ops.rebucket(words, n_bins, n_bins) is words and ops.launches["rebucket"] == before + 1


@pytest.mark.parametrize("b,w,n_bands", [(255_000, 184, 8), (256, 184, 8), (250_000, 16, 8),
                                         (9, 13, 5), (3, 1, 8), (1, 1, 1), (7, 32, 32),
                                         (2, 64, 3)])
def test_band_hash_kernel(dev, b, w, n_bands):
    """The prefilter's shapes (a compacted NYTimes segment, a query chunk, a
    quarter of the 1M-doc clustered corpus), W not a multiple of the bands,
    more bands than words, B = W = 1; words with the top bit set."""
    gen = torch.Generator(device=dev).manual_seed(w)
    words = torch.randint(-(1 << 31), 1 << 31, (b, w), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    words[0] = -1  # every bit set
    before = ops.launches["band_hash"]
    got = ops.band_hash(words, n_bands)
    assert ops.launches["band_hash"] == before + 1
    assert torch.equal(got, ref.band_hash_ref(words, n_bands))
    assert torch.equal(got.cpu(), pk.band_hash(words.cpu(), n_bands))


@pytest.mark.parametrize("b,p,n_bins", [(16384, 870, 5859), (3, 9, 100), (7, 33, 517),
                                        (5, 10, 20), (1, 1, 1), (64, 256, 4096)])
def test_hash_build_kernel(dev, b, p, n_bins):
    """The hash-mode ingest shape (NYTimes at rho 0.05), N % 32 != 0 and
    N < 32, indices up to 2^31 - 1, and a row of pads only."""
    gen = torch.Generator(device=dev).manual_seed(p)
    idx = torch.randint(0, (1 << 31) - 1, (b, p), generator=gen, device=dev, dtype=torch.int32)
    lens = torch.randint(0, p + 1, (b, 1), generator=gen, device=dev)
    idx = torch.where(torch.arange(p, device=dev)[None, :] < lens, idx, -1).to(torch.int32)
    idx[0] = -1
    coeffs = torch.tensor([0x9E3779B1, 0xDEADBEEF], dtype=torch.int64)
    before = ops.launches["hash_build"]
    got = ops.hash_build_sketch(idx, coeffs.to(dev), n_bins)
    assert ops.launches["hash_build"] == before + 1
    assert torch.equal(got, ref.hash_build_ref(idx, coeffs, n_bins))
    assert not got[0].any()


def _ragged_ids(gen, b, p, lo, hi, dev):
    """(b, p) int32 ids drawn from [lo, hi), ragged rows padded with -1; row 0
    all pads where there are other rows."""
    ids = torch.randint(lo, hi, (b, p), generator=gen, device=dev, dtype=torch.int64)
    lens = torch.randint(0, p + 1, (b, 1), generator=gen, device=dev)
    ids = torch.where(torch.arange(p, device=dev)[None, :] < lens, ids, -1).to(torch.int32)
    if b > 1:
        ids[0] = -1
    return ids


def _misaligned(ids):
    """The same ids as a contiguous view 4 bytes past a 16-byte-aligned base:
    ``flat[1 : 1 + B*P].view(B, P)``."""
    b, p = ids.shape
    flat = torch.empty(b * p + 1, dtype=torch.int32, device=ids.device)
    view = flat[1 : 1 + b * p].view(b, p)
    view.copy_(ids)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _in_row_chunks(fn, ids, rows=256):
    """The plain version row chunk by row chunk, where a whole batch of the
    widest rows would not fit its dense (B, N) intermediates."""
    return torch.cat([fn(ids[s : s + rows]) for s in range(0, ids.shape[0], rows)])


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("p", [869, 870, 871, 872])
@pytest.mark.parametrize("b", [1, 3, 256, 16384])
def test_bitmap_builds_ragged(dev, b, p, aligned):
    """Both builds of the warp-per-row kernel, bit-exact to their plain
    versions where its 16-byte windows are ragged: P % 4 in {0, 1, 2, 3}
    around the ingest shape's 870, a base 4 bytes past alignment, one row to
    an ingest batch, N from 1 to the widest row (32 * MAX_WORDS), ids >= N
    and negative, rows of pads only, coefficients as int64 and as int32
    holding the uint32 bits."""
    from repro_torch.hopper.sketch_build import MAX_WORDS

    gen = torch.Generator(device=dev).manual_seed(b * 1000 + p)
    coeffs64 = torch.tensor([0x9E3779B1, 0xDEADBEEF], dtype=torch.int64, device=dev)
    coeffs32 = pk._to_int32_bits(coeffs64)
    for n_bins in (1, 31, 517, 5859, 32 * MAX_WORDS):
        bins = _ragged_ids(gen, b, p, -3, n_bins + 40, dev)
        idx = _ragged_ids(gen, b, p, -(1 << 31), (1 << 31) - 1, dev)
        if not aligned:
            bins, idx = _misaligned(bins), _misaligned(idx)
        before = dict(ops.launches)
        got = ops.build_sketch(bins, n_bins)
        assert torch.equal(got, _in_row_chunks(lambda x: ref.build_sketch_ref(x, n_bins), bins))
        for co in (coeffs64, coeffs32):
            got = ops.hash_build_sketch(idx, co, n_bins)
            want = _in_row_chunks(lambda x: ref.hash_build_ref(x, coeffs64, n_bins), idx)
            assert torch.equal(got, want)
            if b > 1:
                assert not got[0].any()
        assert ops.launches["build_sketch"] == before["build_sketch"] + 1
        assert ops.launches["hash_build"] == before["hash_build"] + 2


def test_hash_build_is_one_kernel(dev):
    """At the hash-mode ingest shape, a call of ``ops.hash_build_sketch`` on
    the mapping's int64 coefficients puts exactly one operation on the card,
    the build kernel, as ``torch.profiler`` records it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(5)
    idx = _ragged_ids(gen, 16384, 870, 0, (1 << 31) - 1, dev)
    coeffs = torch.tensor([0x9E3779B1, 0xDEADBEEF], dtype=torch.int64, device=dev)
    ops.hash_build_sketch(idx, coeffs, 5859)  # build and load the library first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.hash_build_sketch(idx, coeffs, 5859)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_card) == 5, on_card
    assert all("bitmap_build_kernel" in name for name in on_card), on_card


def test_head_counters_take_two_bytes_a_bin_on_the_card(dev):
    """The counting head stores 16 bits a bin on the card, and counts past
    int16's range (but inside u16's) widen back exactly."""
    from repro_torch.core import BinSketchConfig, counting
    from repro_torch.engine import SegmentedStore

    cfg = BinSketchConfig(d=50_000, n_bins=64)
    mapping = torch.zeros(cfg.d, dtype=torch.int32, device=dev)  # every element -> bin 0
    store = SegmentedStore.create(cfg, mapping, capacity=4)
    rows = torch.full((2, 40_000), -1, dtype=torch.int32, device=dev)
    rows[0] = torch.arange(40_000, device=dev)
    rows[1, :10] = torch.arange(10, device=dev)
    store.add(rows, backend=None)
    h = store.head
    assert h.counters.dtype == torch.int16 and h.counters.device.type == "cuda"
    assert h.counters.element_size() * h.counters.numel() == 2 * h.capacity * cfg.n_bins
    assert counting.widen(h.counters[:2, 0]).tolist() == [40_000, 10]
    assert h.fills[:2].tolist() == [1, 1]


def test_background_compaction_and_checkpoint_on_the_card(dev, tmp_path):
    """A background compaction uploads its host merge at the swap, and a
    checkpoint of the card's store restores onto the card bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import BinSketchConfig, make_mapping
    from repro_torch.engine import SegmentedStore, SketchEngine

    cfg = BinSketchConfig(d=4096, n_bins=517)
    mapping = make_mapping(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    docs = torch.randint(0, cfg.d, (300, 40), generator=gen, device=dev, dtype=torch.int32)
    eng = SketchEngine.build(cfg, mapping, backend="cuda", mutable=True, seal_rows=100)
    eng.add(docs)
    eng.delete([5, 150, 250])
    q = docs[:16]
    want = eng.query(q, 10)
    eng.compact(background=True)
    stats = eng.wait_compaction()
    assert stats["rows_out"] == 297 and eng.store.sealed[0].sketches.device.type == "cuda"
    got = eng.query(q, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    eng.store.save(CheckpointManager(str(tmp_path)), step=1)
    back = SegmentedStore.restore(CheckpointManager(str(tmp_path)), device=dev,
                                  backend=eng.backend)
    again = SketchEngine(back, eng.backend).query(q, 10)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    assert eng.health()["degraded"] == []


def _banded_engine(dev, n=96, seal_rows=24):
    """A mutable ``cuda`` engine over the first ``n`` tiny-corpus rows, sealed
    into banded segments of ``seal_rows``; with the corpus."""
    from repro_torch.core import BinSketchConfig, make_mapping
    from repro_torch.data.synthetic import DATASETS, generate_corpus
    from repro_torch.engine import BandPolicy, SketchEngine

    spec = DATASETS["tiny"]
    idx, lens = generate_corpus(spec, seed=0)
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), 0.05)
    eng = SketchEngine.build(cfg, make_mapping(cfg, seed=0, device=dev), backend="cuda",
                             mutable=True, seal_rows=seal_rows,
                             band_policy=BandPolicy(n_bands=8, min_rows=8,
                                                    max_candidate_frac=1.0))
    for s in range(0, n, seal_rows):
        eng.add(idx[s : s + seal_rows])
    return eng, idx


def test_traces_time_stages_with_events_on_the_card(dev):
    """A sampled banded query answers bit-equal to the disarmed one and
    reports every stage with a positive duration from its CUDA events."""
    from repro_torch import obs

    eng, idx = _banded_engine(dev)
    rows = idx[[0, 10, 30, 50, 70, 90]]
    off = eng.query(rows, 5)
    reg = obs.enable()
    try:
        on = eng.query(rows, 5)
        tr = obs.trace.active().last()
    finally:
        obs.disable()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert list(tr["stages_s"]) == list(obs.STAGES)
    assert all(v > 0.0 for v in tr["stages_s"].values())
    assert reg.counter("query.calls") == 1


def test_probe_truth_on_a_side_stream(dev):
    """The probe's ground truth on a side stream of the card is the CPU's
    exact top-k, its reading the recall of the engine's own answers against
    it, and it starts no thread."""
    import threading

    import numpy as np

    from repro_torch import obs

    eng, idx = _banded_engine(dev)
    before = set(threading.enumerate())
    obs.enable()
    try:
        pr = obs.RecallProbe(eng, k=5, sample=16, seed=3)
        assert pr.launch(np.arange(96), idx[:96])
        assert set(threading.enumerate()) <= before
        got = pr.wait()
    finally:
        obs.disable()
    queries = idx[:96][np.random.default_rng(3).choice(96, 16, replace=False)]
    truth = obs.exact_topk(idx[:96], queries, 5, device="cpu")
    np.testing.assert_array_equal(obs.exact_topk(idx[:96], queries, 5, device=dev), truth)
    ids = eng.query(queries, 5)[1].cpu().numpy()
    assert got == sum(len(set(ids[i].tolist()) & set(truth[i].tolist()))
                      for i in range(16)) / (16 * 5)


def test_dedup_on_the_card_equals_the_plain_path(dev):
    """``find_near_duplicates`` on the card (build and score kernels) returns
    the CPU path's pairs in the same order, estimates within rtol 1e-5 /
    atol 1e-6, and finds the planted duplicates; both kernels launch."""
    import numpy as np

    from repro_torch.core import BinSketchConfig, make_mapping
    from repro_torch.data import find_near_duplicates
    from repro_torch.data.synthetic import DATASETS, generate_corpus, generate_similar_pairs

    spec = DATASETS["tiny"]
    a, b, _ = generate_similar_pairs(spec, jaccard=0.95, n_pairs=8, seed=3)
    idx, _ = generate_corpus(spec, seed=9)
    docs = np.concatenate([idx[:200], a, b])  # duplicates at (200 + k, 208 + k)
    cfg = BinSketchConfig.from_sparsity(spec.d, int((docs >= 0).sum(1).max()), 0.05)
    mapping = make_mapping(cfg, seed=0, device="cpu")
    before = dict(ops.launches)
    got = find_near_duplicates(docs, spec.d, threshold=0.5, chunk=64, device=dev,
                               mapping=mapping)
    assert ops.launches["sketch_score"] - before["sketch_score"] == 4  # 216 rows, chunk 64
    assert ops.launches["build_sketch"] > before["build_sketch"]
    want = find_near_duplicates(docs, spec.d, threshold=0.5, chunk=64, device="cpu",
                                mapping=mapping)
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    torch.testing.assert_close(torch.tensor([s for *_, s in got]),
                               torch.tensor([s for *_, s in want]), rtol=1e-5, atol=1e-6)
    assert {(200 + k, 208 + k) for k in range(8)} <= {(i, j) for i, j, _ in got}


@pytest.mark.parametrize("name", ["bcs", "minhash", "doph", "oddsketch", "simhash", "cbe"])
def test_baseline_on_the_card_equals_the_cpu(dev, name):
    """Each baseline's sketch on the card equals the same function on the
    CPU over the same parameters: bit for bit, CBE's bits wherever the
    projection is more than 1e-3·‖x‖ from 0."""
    import numpy as np

    from repro_torch.core.baselines import bcs, cbe, doph, minhash, oddsketch, simhash
    from repro_torch.data.synthetic import DATASETS, generate_corpus

    spec = DATASETS["tiny"]
    rows = torch.from_numpy(generate_corpus(spec, seed=0)[0][:64])
    d, k = spec.d, 300
    make, run = {
        "bcs": (lambda dv: bcs.make_mapping(d, k, device=dv),
                lambda p, x: bcs.sketch_indices(p, k, x)),
        "minhash": (lambda dv: minhash.make_hashes(k, device=dv), minhash.sketch_indices),
        "doph": (lambda dv: doph.make_hashes(device=dv),
                 lambda p, x: doph.sketch_indices(p, k, x)),
        "oddsketch": (lambda dv: oddsketch.make_hashes(k, device=dv),
                      lambda p, x: oddsketch.sketch_indices(p, 517, x)),
        "simhash": (lambda dv: simhash.make_hashes(k, device=dv), simhash.sketch_indices),
        "cbe": (lambda dv: cbe.make_params(d, device=dv),
                lambda p, x: cbe.project_indices(p, k, d, x)),
    }[name]
    on_card, on_cpu = run(make(dev), rows.to(dev)), run(make("cpu"), rows)
    on_card = on_card if isinstance(on_card, tuple) else (on_card,)
    on_cpu = on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)
    for g, w in zip(on_card, on_cpu):
        g = g.cpu()
        if name == "cbe":
            norm = (rows >= 0).sum(1, keepdim=True).double().sqrt()
            clear = w.double().abs() > 1e-3 * norm
            assert clear.double().mean() > 0.99
            assert torch.equal((g >= 0)[clear], (w >= 0)[clear])
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert np.isfinite(on_card[0].float().cpu().numpy()).all()
