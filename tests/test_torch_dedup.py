"""Port parity, near-duplicate search and what rides with it:
``repro_torch.data.dedup.find_near_duplicates``, the backend registry's
``register_backend``, ``repro_torch.core.categorical`` and
``repro_torch.data.synthetic.generate_similar_pairs``, held to the JAX package
on the CPU; and the port's two examples, run in-process with ``--device cpu``.

Dedup runs the JAX package on ``oracle`` and the port with the same Ψ table
(``convert.mapping_from_reference``) on ``device="cpu"``: the pair lists
must be equal, in order, and the estimates allclose at rtol 1e-5 / atol 1e-6
on ``auto`` (the score kernel's plain version, which reproduces XLA's
rounding of the estimator). On ``reference`` (PyTorch's unfused float32
``log``) they are held at rtol 2e-3 / atol 1e-3, the port's tolerance
against the unfused JAX oracle (``tests/test_kernels.py:72``).
"""

import functools
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import make_mapping as j_make_mapping
from repro.core import categorical as jcat
from repro.data import synthetic as jsyn
from repro.data.dedup import find_near_duplicates as j_find
from repro_torch.convert import config_from_reference, mapping_from_reference
from repro_torch.core import categorical as tcat
from repro_torch.core import make_mapping
from repro_torch.data import synthetic as tsyn
from repro_torch.data.dedup import find_near_duplicates
from repro_torch.engine import ReferenceBackend, available_backends, get_backend
from repro_torch.engine import backends as tbackends
from repro_torch.engine import register_backend

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
SPEC = jsyn.DATASETS["tiny"]


def _planted():
    """``tests/test_system.py:36``'s 56 docs: 48 corpus rows, then 4 pairs
    of 0.95-Jaccard duplicates at (48..51, 52..55)."""
    a, b, _ = jsyn.generate_similar_pairs(SPEC, jaccard=0.95, n_pairs=8, seed=3)
    idx, _ = jsyn.generate_corpus(SPEC, seed=9)
    return np.concatenate([idx[:48], a[:4], b[:4]])


def _ragged():
    """216 docs (200 corpus rows, 8 pairs at J=0.95): at chunk 64 the tail of
    24 rows pads up to its planner bucket."""
    a, b, _ = jsyn.generate_similar_pairs(SPEC, jaccard=0.95, n_pairs=8, seed=3)
    idx, _ = jsyn.generate_corpus(SPEC, seed=9)
    return np.concatenate([idx[:200], a, b])


SETS = {"planted": (_planted, 0.8, 1024), "ragged": (_ragged, 0.3, 64)}


def _port_mapping(docs, rho=0.05):
    """The JAX package's Ψ table for ``find_near_duplicates``'s config."""
    psi = int((docs >= 0).sum(1).max())
    cfg = JCfg.from_sparsity(SPEC.d, psi, rho)
    tcfg = config_from_reference(cfg.d, cfg.n_bins, cfg.mode)
    return mapping_from_reference(np.array(j_make_mapping(cfg, jax.random.PRNGKey(0))), tcfg, CPU)


@functools.lru_cache(maxsize=None)
def _reference(name):
    make, threshold, chunk = SETS[name]
    return j_find(make(), SPEC.d, threshold=threshold, rho=0.05, chunk=chunk,
                  backend="oracle")


@pytest.mark.parametrize("backend,rtol,atol", [("auto", 1e-5, 1e-6),
                                               ("reference", 2e-3, 1e-3)])
@pytest.mark.parametrize("name", sorted(SETS))
def test_pairs_equal_to_reference(name, backend, rtol, atol):
    make, threshold, chunk = SETS[name]
    docs = make()
    want = _reference(name)
    got = find_near_duplicates(docs, SPEC.d, threshold=threshold, rho=0.05, chunk=chunk,
                               backend=backend, device=CPU, mapping=_port_mapping(docs))
    assert len(want) >= 4
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    assert all(type(i) is int and type(j) is int and i < j for i, j, _ in got)
    np.testing.assert_allclose([s for _, _, s in got], [s for _, _, s in want],
                               rtol=rtol, atol=atol)
    assert all(s >= threshold for _, _, s in got)


def test_dedup_finds_planted_duplicates():
    """``tests/test_system.py``'s planted-duplicate case with the port's own Ψ."""
    pairs = find_near_duplicates(_planted(), SPEC.d, threshold=0.8, rho=0.05, device=CPU)
    found = {(i, j) for i, j, _ in pairs}
    for k in range(4):
        assert (48 + k, 52 + k) in found, f"planted dup {k} missed: {found}"


def test_dedup_rejects_a_mapping_of_the_wrong_width():
    with pytest.raises(ValueError, match="d="):
        find_near_duplicates(_planted(), SPEC.d, device=CPU,
                             mapping=torch.zeros(7, dtype=torch.int32))


def test_register_backend_reaches_get_backend_and_dedup(monkeypatch):
    """A factory registered under a new name is what ``get_backend`` returns,
    and dedup scores through it."""
    monkeypatch.setattr(tbackends, "_REGISTRY", dict(tbackends._REGISTRY))
    assert {"reference", "cuda", "auto"} <= set(available_backends())
    calls = []

    class Counting(ReferenceBackend):
        name = "counting"

        def score(self, q, corpus, n_bins, measure, **kw):
            calls.append((q.shape[0], corpus.shape[0], measure))
            return super().score(q, corpus, n_bins, measure, **kw)

    register_backend("counting", Counting)
    assert "counting" in available_backends()
    assert isinstance(get_backend("counting"), Counting)
    docs = _planted()
    got = find_near_duplicates(docs, SPEC.d, threshold=0.8, chunk=16, backend="counting",
                               device=CPU, mapping=_port_mapping(docs))
    assert calls == [(16, 56, "jaccard")] * 3 + [(8, 56, "jaccard")]
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in
                                           find_near_duplicates(docs, SPEC.d, threshold=0.8,
                                                                chunk=16, device=CPU,
                                                                mapping=_port_mapping(docs))]
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("nope")


# ------------------------------------------------------------- categorical
def _categorical_data():
    rng = np.random.default_rng(5)
    data = np.stack([rng.integers(0, 7, 40), rng.integers(100, 103, 40),
                     rng.choice([-5, 0, 5, 9], 40), rng.integers(0, 50, 40)], axis=1)
    return data, rng.integers(-10, 60, (12, 4))  # fitted rows, rows with unseen values


def test_categorical_encoder_and_distance_equal_reference():
    data, unseen = _categorical_data()
    j_enc, t_enc = jcat.CategoricalEncoder.fit(data), tcat.CategoricalEncoder.fit(data)
    assert t_enc.d == j_enc.d and np.array_equal(t_enc.offsets, j_enc.offsets)
    assert all(np.array_equal(a, b) for a, b in zip(t_enc.vocabs, j_enc.vocabs))
    for rows in (data, unseen):
        got = t_enc.transform(rows)
        assert got.dtype == np.int32 and np.array_equal(got, j_enc.transform(rows))
    assert np.array_equal(tcat.categorical_distance(data[:20], data[20:]),
                          jcat.categorical_distance(data[:20], data[20:]))


def test_categorical_sketch_bit_equal_under_the_same_psi():
    data, _ = _categorical_data()
    j_enc, t_enc = jcat.CategoricalEncoder.fit(data), tcat.CategoricalEncoder.fit(data)
    cfg = JCfg(d=j_enc.d, n_bins=37)
    mapping = j_make_mapping(cfg, jax.random.PRNGKey(2))
    want = np.asarray(j_enc.sketch(cfg, mapping, data))
    tcfg = config_from_reference(cfg.d, cfg.n_bins)
    got = t_enc.sketch(tcfg, mapping_from_reference(np.array(mapping), tcfg, CPU), data)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="one-hot dim"):
        t_enc.sketch(config_from_reference(cfg.d + 1, 37),
                     make_mapping(config_from_reference(cfg.d + 1, 37), device=CPU), data)
    # one differing feature is two differing one-hot bits
    onehot = t_enc.transform(data)
    for u, v in ((0, 1), (2, 3)):
        sym = len(set(onehot[u]) ^ set(onehot[v]))
        assert sym == 2 * int(tcat.categorical_distance(data[u], data[v]))


# --------------------------------------------------------------- corpora
@pytest.mark.parametrize("name,jaccard,seed", [("tiny", 0.95, 3), ("kos", 0.5, 1)])
def test_generate_similar_pairs_equal_to_reference(name, jaccard, seed):
    want = jsyn.generate_similar_pairs(jsyn.DATASETS[name], jaccard, 6, seed=seed)
    got = tsyn.generate_similar_pairs(tsyn.DATASETS[name], jaccard, 6, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -------------------------------------------------------------- examples
def _example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys):
    _example("quickstart_torch").main(["--device", CPU])
    out = capsys.readouterr().out
    assert "Theorem-1 sketch length" in out and "distilled" in out
    assert "telemetry: query.calls=1" in out


def test_ranking_service_torch_runs_on_the_cpu(capsys):
    recall = _example("ranking_service_torch").main(["--device", CPU, "--queries", "16"])
    assert 0.3 <= recall <= 1.0
    assert "recall@10 vs exact Jaccard" in capsys.readouterr().out
