"""The port's serving export (``vgan_tpu_torch.serving``) against
``vgan_tpu.serving`` and against the port's own live calls, on the CPU.

- The sampler: the port's loaded program and ``vgan_tpu``'s loaded program
  on the same numpy z, the weights carried across by a ``vgan_tpu``
  ``.msgpack``: masks equal (a threshold of the same float32 products).
- The scorers' loaded programs against ``vgan_tpu``'s loaded programs on the
  same data and masks: rtol ``RTOL`` = 1e-5 plus ``ATOL`` = 1e-6 (float32
  scores formed in other summation orders, then z-scored), as
  ``tests/test_serving.py`` holds ``vgan_tpu``'s export to its live call.
- The heterogeneous export against the live ``decision_function``: rtol
  2e-4 and atol 1e-5, ``tests/test_serving.py``'s limits.

Every native base's ensemble and per-subspace exports are held in
``test_torch_serving_bases.py``.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vgan_tpu.serving as JS
import vgan_tpu_torch.ensemble.od as TOD
import vgan_tpu_torch.serving as TS
from vgan_tpu import VGAN_no_kl as JVGAN_no_kl
from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble
from vgan_tpu.train import steps as JSTEPS
from vgan_tpu_torch import VGAN_no_kl
from vgan_tpu_torch.ensemble import HeterogeneousEnsemble, SubspaceEnsemble
from test_torch_bases import one_torch_thread  # noqa: F401  (module fixture)

RTOL, ATOL = 1e-5, 1e-6
HET_RTOL, HET_ATOL = 2e-4, 1e-5
D = 24


def _jax_generator_file(path, d: int, seed: int):
    """A ``vgan_tpu`` generator's params, written as ``vgan_tpu`` writes them."""
    config = JSTEPS.TrainConfig(ndims=d, batch_size=32)
    module = config.generator_module(kl=False)
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, config.latent_size)))
    path.write_bytes(flax.serialization.to_bytes(params))
    return config.latent_size


@pytest.fixture(scope="module")
def generator_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("gen") / "generator_0.msgpack"
    latent = _jax_generator_file(path, D, seed=3)
    return path, latent


@pytest.mark.parametrize("batch", [16, 7])
def test_sampler_matches_jax_loaded_program(generator_file, tmp_path, batch):
    path, latent = generator_file
    jm = JVGAN_no_kl(verbose=False)
    jm.load_models(path, ndims=D)
    JS.export_sampler(jm, tmp_path / "jax_sampler.bin")
    tm = VGAN_no_kl(verbose=False, device="cpu")
    tm.load_models(path, ndims=D)
    TS.export_sampler(tm, tmp_path / "sampler.pt2")
    z = np.random.default_rng(batch).normal(size=(batch, latent)).astype(np.float32)
    want = np.asarray(JS.load_sampler(tmp_path / "jax_sampler.bin")(z))
    got = TS.load_sampler(tmp_path / "sampler.pt2")(z)
    assert got.dtype == np.bool_ and want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def test_sample_masks_equals_generate_subspaces(generator_file, tmp_path):
    path, latent = generator_file
    tm = VGAN_no_kl(verbose=False, device="cpu", seed=5)
    tm.load_models(path, ndims=D)
    TS.export_sampler(tm, tmp_path / "sampler.pt2")
    fn = TS.load_sampler(tmp_path / "sampler.pt2")
    for n in (40, 3):
        np.testing.assert_array_equal(TS.sample_masks(fn, n, latent, seed=5),
                                      tm.generate_subspaces(n))
    a = TS.sample_masks(fn, 9, latent, seed=8)
    np.testing.assert_array_equal(a, TS.sample_masks(fn, 9, latent, seed=8))


def _pool(seed, n_masks, d):
    rng = np.random.default_rng(seed)
    masks = rng.random((n_masks, d)) < 0.5
    masks[:, 0] |= ~masks.any(axis=1)
    return masks, np.full(n_masks, 1.0 / n_masks, np.float32)


@pytest.mark.parametrize("base,kw", [
    ("knn", dict(k=4)), ("lof", dict(k=5)), ("ecod", {}), ("kde", {}), ("mahalanobis", {}),
])
def test_loaded_scorers_match_jax_loaded(tmp_path, base, kw):
    """The port's loaded ensemble program against ``vgan_tpu``'s loaded
    program (StableHLO, on the CPU), the same rows, masks and knobs."""
    d = 9
    rng = np.random.default_rng(11)
    xtr = rng.normal(size=(50, d)).astype(np.float32)
    masks, proba = _pool(12, 6, d)
    jens = JaxEnsemble(masks, proba, base=base, chunk=4, **kw).fit(xtr)
    tens = SubspaceEnsemble(masks, proba, base=base, chunk=4, device="cpu", **kw).fit(xtr)
    JS.export_ensemble_scorer(jens, tmp_path / "jax.bin")
    TS.export_ensemble_scorer(tens, tmp_path / "port.pt2")
    jfn = JS.load_ensemble_scorer(tmp_path / "jax.bin")
    tfn = TS.load_ensemble_scorer(tmp_path / "port.pt2")
    for nt in (13, 4):
        xte = rng.normal(size=(nt, d)).astype(np.float32)
        np.testing.assert_allclose(tfn(xte), jfn(xte), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def hetero_data():
    d = 9
    rng = np.random.default_rng(21)
    xtr = rng.normal(size=(70, d)).astype(np.float32)
    masks, proba = _pool(22, 7, d)
    return xtr, masks, proba, [rng.normal(size=(nt, d)).astype(np.float32) for nt in (12, 25)]


HETERO_CASES = {
    "average": dict(combination="average"),
    "max": dict(combination="max"),
    "select": dict(combination="select"),
    "weighted": dict(combination="weighted", weights=[3.0, 1.0, 1.0]),
    "distilled": dict(combination="average", distill=[0]),
    "jl_first": dict(combination="average",
                     members=[{"base": "knn", "k": 6, "jl_dim": 5}, {"base": "ecod"},
                              {"base": "loda", "n_projections": 24}]),
}


@pytest.mark.parametrize("case", sorted(HETERO_CASES))
def test_hetero_export_matches_live(hetero_data, tmp_path, case):
    xtr, masks, proba, tests = hetero_data
    kw = dict(HETERO_CASES[case])
    distill = kw.pop("distill", None)
    members = kw.pop("members", [{"base": "knn", "k": 6}, {"base": "ecod"},
                                 {"base": "loda", "n_projections": 24}])
    het = HeterogeneousEnsemble(masks, proba, members=members, device="cpu", **kw).fit(xtr)
    if distill is not None:
        het.distill(members=distill, n_features=64)
    TS.export_hetero_scorer(het, tmp_path / "het.pt2")
    fn = TS.load_ensemble_scorer(tmp_path / "het.pt2")
    for xte in tests:
        got = fn(xte)
        np.testing.assert_allclose(got, het.decision_function(xte), rtol=HET_RTOL,
                                   atol=HET_ATOL)
        np.testing.assert_array_equal(got, fn(xte))


@pytest.mark.parametrize("base", ["knn", "lof"])
def test_streaming_export_matches_live(tmp_path, monkeypatch, base):
    """A train set past ``STREAM_NTR`` streams in the program: the streamed
    tiles size from ``_EXPORT_NT_HINT`` (the batch is symbolic), here in
    16-row blocks, and the loaded program matches the live call."""
    monkeypatch.setattr(TOD, "STREAM_NTR", 32)
    monkeypatch.setattr(TOD, "_STREAM_BLOCK", 16)
    monkeypatch.setattr(TOD, "_MERGE_BLOCK", 16)
    rng = np.random.default_rng(31)
    xtr = rng.normal(size=(64, 6)).astype(np.float32)
    masks, proba = _pool(32, 5, 6)
    ens = SubspaceEnsemble(masks, proba, base=base, k=4, device="cpu").fit(xtr)
    TS.export_ensemble_scorer(ens, tmp_path / "stream.pt2")
    fn = TS.load_ensemble_scorer(tmp_path / "stream.pt2")
    for nt in (9, 21):
        xte = rng.normal(size=(nt, 6)).astype(np.float32)
        np.testing.assert_allclose(fn(xte), ens.decision_function(xte), rtol=RTOL, atol=ATOL)


def test_refusals(tmp_path):
    rng = np.random.default_rng(41)
    xtr = rng.normal(size=(30, 5)).astype(np.float32)
    masks, proba = _pool(42, 4, 5)
    with pytest.raises(RuntimeError, match="fit"):
        TS.export_ensemble_scorer(SubspaceEnsemble(masks, proba, device="cpu"), tmp_path / "a")

    class Detector:  # a pyod-style instance
        def get_params(self):
            return {}

    pyod = SubspaceEnsemble(masks, proba, base=Detector(), device="cpu").fit(xtr)
    for export in (TS.export_ensemble_scorer, TS.export_per_subspace_scorer):
        with pytest.raises(ValueError, match="native"):
            export(pyod, tmp_path / "b")
    for aggregation in ("aom", "moa", "median", "vote"):
        ens = SubspaceEnsemble(masks, proba, aggregation=aggregation, device="cpu").fit(xtr)
        with pytest.raises(ValueError, match="does not export"):
            TS.export_ensemble_scorer(ens, tmp_path / "c")
        het = HeterogeneousEnsemble(masks, proba, device="cpu", aggregation=aggregation,
                                    members=[{"base": "knn", "k": 3}, {"base": "ecod"}]).fit(xtr)
        with pytest.raises(ValueError, match="does not export"):
            TS.export_hetero_scorer(het, tmp_path / "d")
    # the per-subspace program serves the bucketed aggregations
    ens = SubspaceEnsemble(masks, proba, aggregation="aom", k=3, device="cpu").fit(xtr)
    TS.export_per_subspace_scorer(ens, tmp_path / "e.pt2")
    xte = rng.normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(TS.load_ensemble_scorer(tmp_path / "e.pt2")(xte),
                               ens.per_subspace_scores(xte), rtol=RTOL, atol=ATOL)
    het = HeterogeneousEnsemble(masks, proba, combination="vote", device="cpu",
                                members=[{"base": "knn", "k": 3}, {"base": "ecod"}]).fit(xtr)
    with pytest.raises(ValueError, match="vote"):
        TS.export_hetero_scorer(het, tmp_path / "f")
    assert not any((tmp_path / n).exists() for n in "abcdf")
