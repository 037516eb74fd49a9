"""The port's non-parametric ensemble bases (lof, abod, cof, mahalanobis)
and its dimension-decomposable bases (copod, hbos, ecod) against
``vgan_tpu.ensemble.od``: each scorer in float64 on the same inputs, in the
dense and the streamed regime, and ``SubspaceEnsemble(device="cpu")`` for
each base, and for the ported parametric bases (mcd, pca, kpca, cblof, gmm,
kde; their scorers are held in ``test_torch_param_bases.py``), against the
JAX ensemble. cblof and gmm are fed the JAX package's centroid draws
(fixture ``jax_draws``).

Neighbour ties: the port takes the k nearest by ``(value, index)`` in both
regimes, as the JAX package's streamed k-pass merge does. The JAX package's
dense selection (``jax.lax.approx_min_k``) returns tied neighbours in an
unspecified order off the TPU (on the CPU a 40-wide row of small integers
gives tied indices neither in index order nor the smallest ones), so on
tie-heavy rows in the dense regime the JAX side runs with that call replaced
by a stable selection (``stable_jax_selection``). Gaussian rows have no ties.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ensemble.od as JOD
import vgan_tpu_torch.ensemble.od as TOD
from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble
from vgan_tpu_torch import SubspaceEnsemble
from test_torch_param_bases import jax_centroid_draws

# float64 on both sides, the same operations: a few ulp.
RTOL64 = 1e-9
# the JAX package forms copod's and ecod's ECDF tails in float32 whatever the
# input dtype (int32 counts over n promote to float32), so they are held in
# float32 to a few ulp of it.
RTOL_F32 = 1e-6
# ensembles: f32 scores formed in other summation orders, then z-scored and
# summed over masks (as tests/test_torch_ensemble.py).
RTOL = 1e-5
ATOL_FRAC = 1e-5
AGGREGATIONS = ["average", "max", "aom", "median", "vote"]
NEIGHBOR = ["lof", "abod", "cof"]
PARAM_BASES = ["mcd", "pca", "kpca", "cblof", "gmm", "kde"]
# The ensembles are float32 on both sides. gmm takes 3 components: 8 on 70
# rows collapse onto a few rows each, with variances at the 1e-6 floor, and
# 30 EM iterations carry each side's rounding to 2e-5 of the train scores.
# kpca keeps its leading 4 components: on masks of one to four columns the
# kernel spectrum reaches 1e-5 lambda_max within a few components, where
# float32 eigh noise (about n 2^-24 lambda_max) is a sizeable part of the
# eigenvalue a projection is divided by (test_torch_param_bases.py holds
# every component in float64).
BASE_KW = dict(gmm=dict(n_clusters=3), kpca=dict(kpca_n_components=4))
ENSEMBLE_BASES = ["lof", "abod", "cof", "mahalanobis", "copod", "hbos", "ecod", *PARAM_BASES]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=ATOL_FRAC * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module (the port's test files that import
    this fixture too): their ops are tiny, and with several test workers on
    the machine torch's spinning OpenMP threads made a trained base's
    ensemble case 9x slower (ae's predict case: 74 s against 8.6 s beside
    five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(rng, n, d, integer):
    if integer:  # small integers: heavy ties, exact distances
        return rng.integers(-2, 3, size=(n, d)).astype(np.float64)
    return rng.normal(size=(n, d))


def _scorer_data(integer, seed=0, ntr=50, nt=20, d=7):
    rng = np.random.default_rng(seed)
    xtr, xte = _rows(rng, ntr, d, integer), _rows(rng, nt, d, integer)
    xte[:5] = xtr[:5]  # duplicated rows: zero distances
    masks = rng.random((5, d)) < 0.5
    masks[0] = False  # all-zero: every distance 0
    masks[1] = True
    masks[2] = False
    masks[2, 3] = True  # one column
    return xte, xtr, masks


@pytest.fixture
def stable_jax_selection(monkeypatch):
    """Replace the JAX package's dense ``approx_min_k`` by a selection in
    (value, index) order for the duration of a test."""

    def stable_min_k(x, k, recall_target=1.0, **kwargs):
        idx = jnp.argsort(x, axis=-1, stable=True)[..., :k]
        return jnp.take_along_axis(x, idx, axis=-1), idx.astype(jnp.int32)

    monkeypatch.setattr(jax.lax, "approx_min_k", stable_min_k)


def _port_scores(name, xte, xtr, masks, k, **kw):
    fn = getattr(TOD, f"{name}_scores_masked")
    return fn(torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks), k, **kw)


def _jax_scores(name, xte, xtr, masks, k, **kw):
    """The JAX scorer vmapped over the masks, as its ensemble runs it."""
    fn = functools.partial(getattr(JOD, f"{name}_scores_masked"), k=k, **kw)
    batched = jax.jit(jax.vmap(lambda m: fn(jnp.asarray(xte), jnp.asarray(xtr), m)))
    return np.asarray(batched(jnp.asarray(masks)))


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("name", NEIGHBOR)
def test_neighbor_scorers_vs_jax(stable_jax_selection, name, exclude_self, integer):
    """One batched call over a (5, d) chunk (an all-zero, an all-column and
    a one-column mask among them) against the JAX scorer mask by mask."""
    xte, xtr, masks = _scorer_data(integer)
    got = _port_scores(name, xte, xtr, masks, 5, exclude_self=exclude_self)
    assert got.shape == (len(masks), len(xte)) and got.dtype == torch.float64
    assert torch.all(torch.isfinite(got))
    np.testing.assert_allclose(got.numpy(), _jax_scores(name, xte, xtr, masks, 5,
                                                        exclude_self=exclude_self), rtol=RTOL64)
    one = _port_scores(name, xte, xtr, masks[1], 5, exclude_self=exclude_self)
    assert one.shape == (len(xte),)
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=RTOL64)


@pytest.mark.parametrize("integer", [False, True])
def test_mahalanobis_vs_jax(integer):
    xte, xtr, masks = _scorer_data(integer)
    xte[6] *= 40.0
    got = _port_scores("mahalanobis", xte, xtr, masks, 0)
    assert torch.all(torch.isfinite(got))
    np.testing.assert_allclose(got.numpy(), _jax_scores("mahalanobis", xte, xtr, masks, 0),
                               rtol=RTOL64, atol=1e-12)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)  # the all-zero mask


def test_mahalanobis_failed_factorization_is_nan():
    """A NaN train row makes every covariance NaN: the scores are NaN, as
    JAX's Cholesky gives, and nothing raises."""
    xte, xtr, masks = _scorer_data(False)
    xtr[3, 1] = np.nan
    got = _port_scores("mahalanobis", xte, xtr, masks[1:], 0)
    want = _jax_scores("mahalanobis", xte, xtr, masks[1:], 0)
    assert torch.all(torch.isnan(got)) and np.all(np.isnan(want))


@pytest.fixture
def streamed(monkeypatch):
    """``STREAM_NTR`` lowered to 40 on both sides, 16-row train blocks: 70
    train rows stream in five blocks."""
    for mod in (JOD, TOD):
        monkeypatch.setattr(mod, "STREAM_NTR", 40)
        monkeypatch.setattr(mod, "_STREAM_BLOCK", 16)


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("name", NEIGHBOR)
def test_neighbor_scorers_streamed_vs_jax(streamed, name, exclude_self):
    """The streamed regime against the JAX package's lexicographic k-pass
    merge, unpatched: tie-heavy integer rows, and rows duplicated across a
    block boundary."""
    xte, xtr, masks = _scorer_data(True, seed=1, ntr=70)
    xtr[32:40] = xtr[24:32]
    assert TOD._stream_block(70) == JOD._stream_block(70) == 16
    got = _port_scores(name, xte, xtr, masks, 6, exclude_self=exclude_self)
    np.testing.assert_allclose(got.numpy(), _jax_scores(name, xte, xtr, masks, 6,
                                                        exclude_self=exclude_self), rtol=RTOL64)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_streamed_indices_in_value_index_order(streamed, exclude_self):
    """The streamed merge's indices equal the JAX k-pass merge's, and the
    dense selection's; knn's values are those of the dense top-k."""
    xte, xtr, masks = _scorer_data(True, seed=2, ntr=70)
    xtr[32:40] = xtr[24:32]
    te, tr = torch.from_numpy(xte), torch.from_numpy(xtr)
    jax_merge = jax.jit(JOD._masked_knn_streaming, static_argnums=(3, 4))
    for m in masks:
        vals, idx = TOD._masked_knn_streaming(te, tr, torch.from_numpy(m), 9, exclude_self)
        jv, ji = jax_merge(xte, xtr, m, 9, exclude_self)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        d2 = TOD._masked_sq_dists(te, tr, torch.from_numpy(m))
        if exclude_self:
            d2 = TOD._mask_diagonal(d2)
        dv, di = TOD._k_smallest_by_index(d2, 9)
        np.testing.assert_array_equal(di.numpy(), idx.numpy())
        np.testing.assert_array_equal(
            dv.numpy(), torch.topk(d2, 9, largest=False, sorted=True).values.numpy())
        order = np.lexsort((np.arange(70)[None].repeat(len(xte), 0), d2.numpy()), axis=1)
        np.testing.assert_array_equal(di.numpy(), order[:, :9])


@pytest.mark.parametrize("integer", [False, True])
def test_dim_scorers_vs_jax(integer):
    """Tied values (both searchsorted sides), out-of-range test values (hbos
    gives them the floor density) and skewed columns (ecod's auto plane)."""
    rng = np.random.default_rng(3)
    xtr, xte = _rows(rng, 80, 6, integer), _rows(rng, 25, 6, integer)
    xtr[:, 2] = np.abs(xtr[:, 2]) ** 2  # right-skewed
    xtr[:, 3] = -np.abs(xtr[:, 3]) ** 2  # left-skewed
    xte[:4] *= 5.0
    te, tr = torch.from_numpy(xte), torch.from_numpy(xtr)
    for n_bins in (10, 7):
        got = TOD.hbos_dim_scores(te, tr, n_bins=n_bins)
        want = np.asarray(jax.jit(JOD.hbos_dim_scores, static_argnames="n_bins")(
            jnp.asarray(xte), jnp.asarray(xtr), n_bins=n_bins))
        assert got.shape == (25, 6)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL64)
    te32, tr32 = te.float(), tr.float()
    for name, shape in (("copod", (25, 6)), ("ecod", (25, 6, 3))):
        got = getattr(TOD, f"{name}_dim_scores")(te32, tr32)
        want = np.asarray(jax.jit(getattr(JOD, f"{name}_dim_scores"))(
            jnp.asarray(xte, jnp.float32), jnp.asarray(xtr, jnp.float32)))
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_F32)
        got64 = getattr(TOD, f"{name}_dim_scores")(te, tr)
        np.testing.assert_allclose(got64.numpy(), want, rtol=RTOL_F32)
    masks = torch.from_numpy(rng.random((4, 6)) < 0.5).float()
    for planes in (TOD.copod_dim_scores(te32, tr32), TOD.ecod_dim_scores(te32, tr32)):
        want = JOD._dim_subspace_raw(jnp.asarray(planes.numpy()), jnp.asarray(masks.numpy()))
        np.testing.assert_allclose(TOD._dim_subspace_raw(planes, masks).numpy(),
                                   np.asarray(want), rtol=RTOL_F32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xtr = rng.normal(size=(70, 6)).astype(np.float32)
    xte = rng.normal(size=(24, 6)).astype(np.float32)
    xte[:3] *= 4.0  # planted outliers
    masks = rng.random((9, 6)) < 0.5
    masks[~masks.any(axis=1), 0] = True
    return dict(xtr=xtr, xte=xte, masks=masks, proba=rng.random(9))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's centroid draws replaced by the JAX package's (float32
    Gumbel noise, as the JAX ensemble draws in its float32 rows)."""
    draws = functools.lru_cache(maxsize=None)(
        lambda n, c, method, seed: jax_centroid_draws(n, c, method, seed, dtype=jnp.float32))
    monkeypatch.setattr(TOD, "draw_centroids", draws)


def _pair(data, **kw):
    jax_ens = JaxEnsemble(data["masks"], data["proba"], **kw).fit(data["xtr"])
    port = SubspaceEnsemble(data["masks"], data["proba"], device="cpu", **kw).fit(data["xtr"])
    return jax_ens, port


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
@pytest.mark.parametrize("base", ENSEMBLE_BASES)
def test_ensemble_decision_function_vs_jax(data, jax_draws, base, aggregation):
    jax_ens, port = _pair(data, base=base, k=5, aggregation=aggregation, chunk=4,
                          **BASE_KW.get(base, {}))
    got = port.decision_function(data["xte"])
    assert got.shape == (len(data["xte"]),) and np.all(np.isfinite(got))
    _close(got, jax_ens.decision_function(data["xte"]))


def _labels_agree(got, want, scores, threshold):
    """Labels equal except for rows within the tolerance of the threshold."""
    near = np.abs(scores - threshold) <= RTOL * abs(threshold) + ATOL_FRAC * np.abs(scores).max()
    np.testing.assert_array_equal(np.asarray(got)[~near], np.asarray(want)[~near])


@pytest.mark.parametrize("base", ENSEMBLE_BASES)
def test_ensemble_predict_labels_and_test_chunk_vs_jax(data, jax_draws, base):
    jax_ens, port = _pair(data, base=base, k=5, chunk=4, test_chunk=7, **BASE_KW.get(base, {}))
    labels = port.predict(data["xte"])
    want_labels = jax_ens.predict(data["xte"])
    assert np.isclose(port.threshold_, jax_ens.threshold_, rtol=RTOL,
                      atol=ATOL_FRAC * np.abs(port.decision_scores_).max())
    both = port.decision_function(np.concatenate([data["xtr"], data["xte"]]), exclude_self=True)
    _labels_agree(labels, want_labels, both[len(data["xtr"]):], port.threshold_)
    _close(port.decision_scores_, jax_ens.decision_scores_)
    port_labels = port.labels_
    np.testing.assert_array_equal(port_labels, port.decision_scores_ > port.threshold_)
    _labels_agree(port_labels, jax_ens.labels_, port.decision_scores_, port.threshold_)
    _close(port.decision_function(data["xte"]), jax_ens.decision_function(data["xte"]))
    _close(port.per_subspace_scores(data["xte"]), jax_ens.per_subspace_scores(data["xte"]))


@pytest.mark.parametrize("base", ["lof", "abod", "cof", "iforest", "mahalanobis", "copod",
                                  "hbos", "ecod", *PARAM_BASES])
def test_all_zero_and_padding_masks_give_finite_scores(data, base):
    """Chunk padding appends all-zero masks, and an all-zero mask is in the
    pool: every raw score is finite (the padding's weight-0 product with it
    must not be NaN)."""
    masks = data["masks"].copy()
    masks[4] = False
    ens = SubspaceEnsemble(masks, data["proba"], base=base, k=5, chunk=4, n_trees=16,
                           device="cpu").fit(data["xtr"])
    raw = ens._native_scores(ens._as_device(data["xte"]), False, reduce=False) \
        if base not in TOD._DIM_BASES else ens._raw_per_subspace(data["xte"])
    assert np.all(np.isfinite(np.asarray(raw)))
    assert np.all(np.isfinite(ens.decision_function(data["xte"])))
    assert np.all(np.isfinite(ens.decision_scores_))


def test_lof_vs_sklearn():
    """lof with an all-column mask against sklearn's novelty LOF."""
    neighbors = pytest.importorskip("sklearn.neighbors")
    rng = np.random.default_rng(4)
    xtr = rng.normal(size=(60, 5))
    xte = rng.normal(size=(25, 5))
    xte[:5] += 4.0
    got = TOD.lof_scores_masked(torch.from_numpy(xte), torch.from_numpy(xtr),
                                torch.ones(5, dtype=torch.float64), 10)
    lof = neighbors.LocalOutlierFactor(n_neighbors=10, novelty=True).fit(xtr)
    np.testing.assert_allclose(got.numpy(), -lof.score_samples(xte), rtol=1e-9)


def test_guards_and_parametric_bases(data):
    x = torch.from_numpy(data["xtr"])
    mask = torch.ones(6)
    with pytest.raises(ValueError, match="k >= 2"):
        TOD.abod_scores_masked(x, x, mask, 1)
    with pytest.raises(ValueError, match="k < n_train"):
        TOD.cof_scores_masked(x, x[:5], mask, 5)
    with pytest.raises(ValueError, match="k >= 1"):
        TOD.cof_scores_masked(x, x, mask, 0)
    with pytest.raises(ValueError, match="neighbours requested"):
        TOD.lof_scores_masked(x, x[:4], mask, 5)
    ens = SubspaceEnsemble(data["masks"], data["proba"], base="lof", k=70,
                           device="cpu").fit(data["xtr"])
    with pytest.raises(ValueError, match="k < n_train"):
        ens.predict(data["xte"])
    assert len(TOD._PARAM_BASES) == 15 and set(PARAM_BASES) <= set(TOD._PARAM_BASES)
    for base in TOD._PARAM_BASES:  # every parametric base is ported
        ens = SubspaceEnsemble(data["masks"], data["proba"], base=base, device="cpu")
        assert ens.base == base
    assert set(TOD._BASE_SCORERS) == set(JOD._BASE_SCORERS)
    assert TOD._DIM_BASES == JOD._DIM_BASES and TOD._PARAM_BASES == JOD._PARAM_BASES


def test_effective_chunk_follows_the_jax_governor():
    """Where the eager buffers do not bind, the chunk is the JAX package's."""
    for base, nt, ntr, d, k in (("abod", 500, 1000, 100, 10), ("cof", 50, 100, 20000, 10),
                                ("mahalanobis", 500, 1000, 10240, 0),
                                ("mahalanobis", 500, 1000, 100, 0), ("lof", 40, 50000, 8, 10),
                                ("iforest", 500, 1000, 100, 100)):
        want = JOD._effective_chunk(base, 128, nt, ntr, d, k=k, n_trees=k)
        got = TOD._effective_chunk(base, 128, nt, ntr, d, k)
        assert 1 <= got <= want, (base, got, want)
    assert TOD._effective_chunk("mahalanobis", 128, 500, 2000, 10240) == 1
    knobs = dict(n_clusters=8, gmm_covariance="diag", kpca_sampling=False, subset_size=20,
                 mcd_starts=8)
    for base, nt, ntr, d, kw in (
            ("kde", 500, 1000, 100, {}), ("kde", 500, 40000, 100, {}),
            ("kde", 9000, 40000, 20, {}), ("pca", 500, 1000, 100, {}),
            ("pca", 500, 2000, 10240, {}), ("kpca", 500, 1000, 100, {}),
            ("kpca", 500, 1000, 100, dict(kpca_sampling=True, subset_size=50)),
            ("mcd", 500, 1000, 100, {}), ("mcd", 500, 1000, 100, dict(mcd_starts=2)),
            ("cblof", 500, 2000, 10240, {}), ("gmm", 500, 2000, 10240, {}),
            ("gmm", 500, 1000, 100, dict(gmm_covariance="full", n_clusters=4))):
        cfg = dict(knobs, **kw)
        want = JOD._effective_chunk(base, 128, nt, ntr, d, k=10, **cfg)
        got = TOD._effective_chunk(base, 128, nt, ntr, d, 0, **cfg)
        assert 1 <= got <= want, (base, got, want)
        if base != "kde":
            assert got == want, (base, got, want)
    # kde streams past STREAM_NTR with the wider block (8192 train rows at
    # 500 queries), not capped at _MERGE_BLOCK as the knn merge is
    assert TOD._effective_chunk("kde", 128, 500, 40000, 100) == JOD._effective_chunk(
        "kde", 128, 500, 40000, 100) == 32
    assert TOD._effective_chunk("knn", 128, 500, 40000, 100) > 100
    assert TOD._effective_chunk("abod", 128, 500, 1000, 2000, 10) == JOD._effective_chunk(
        "abod", 128, 500, 1000, 2000, k=10) == 6


@pytest.mark.parametrize("base", ["copod", "hbos", "ecod"])
def test_dim_route_weighted_follows_jax(data, base):
    """On the dim route, 'weighted' aggregates with the pool probabilities
    (the JAX package's ``_dim_decision_function`` passes ``self.proba``),
    not with ``weights=``; the weights still reach 'vote'."""
    weights = np.linspace(0.1, 2.0, len(data["masks"]))
    jax_ens, port = _pair(data, base=base, aggregation="weighted", weights=weights)
    got = port.decision_function(data["xte"])
    _close(got, jax_ens.decision_function(data["xte"]))
    avg = SubspaceEnsemble(data["masks"], data["proba"], base=base, device="cpu").fit(data["xtr"])
    _close(got, avg.decision_function(data["xte"]), rtol=1e-6)
