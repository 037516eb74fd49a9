"""The port's ``SubspaceEnsemble`` (``knn`` / ``knn_mean``) on the CPU
against ``vgan_tpu.ensemble.SubspaceEnsemble`` on the same masks and
probabilities.

The JAX package runs its generic path on the CPU. The port's fused route
(``knn_scores_all_masks``, whose CPU version is the kernels' plain version)
and its generic path are each held to it: ``generic`` forces the latter by
reporting every shape as unsupported by the kernels.
"""

import numpy as np
import pytest
import torch

import vgan_tpu.ensemble.od as JOD
import vgan_tpu_torch.ensemble.od as TOD
from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble
from vgan_tpu_torch import SubspaceEnsemble

# Scores are f32 sums over masks of distances formed in another summation
# order: held to rtol 1e-5 with an atol of 1e-5 of the score scale.
RTOL = 1e-5
ATOL_FRAC = 1e-5
AGGREGATIONS = ["average", "max", "weighted", "aom", "moa", "median", "vote"]


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL_FRAC * max(float(np.abs(want).max()), 1e-30))


def _labels_agree(got, want, scores, threshold):
    """Labels equal except for rows within the tolerance of the threshold."""
    near = np.abs(scores - threshold) <= RTOL * abs(threshold) + ATOL_FRAC * np.abs(scores).max()
    np.testing.assert_array_equal(np.asarray(got)[~near], np.asarray(want)[~near])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xtr = rng.normal(size=(120, 8)).astype(np.float32)
    xte = rng.normal(size=(40, 8)).astype(np.float32)
    xte[:4] *= 3.0  # planted outliers
    masks = rng.random((13, 8)) < 0.4
    masks[~masks.any(axis=1), 0] = True
    return dict(xtr=xtr, xte=xte, masks=masks, proba=rng.random(13), weights=rng.random(13))


@pytest.fixture(params=["fused", "generic"])
def route(request, monkeypatch):
    if request.param == "generic":
        monkeypatch.setattr(TOD, "knn_kernel_supported", lambda *args: False)
    return request.param


def _pair(data, **kw):
    jax_ens = JaxEnsemble(data["masks"], data["proba"], **kw).fit(data["xtr"])
    port = SubspaceEnsemble(data["masks"], data["proba"], device="cpu", **kw).fit(data["xtr"])
    return jax_ens, port


@pytest.mark.parametrize("base", ["knn", "knn_mean"])
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
@pytest.mark.parametrize("normalize", ["zscore", None])
def test_decision_function_vs_jax(data, base, aggregation, normalize):
    kw = dict(base=base, k=5, aggregation=aggregation, normalize=normalize,
              weights=data["weights"] if aggregation == "weighted" else None)
    jax_ens = JaxEnsemble(data["masks"], data["proba"], **kw).fit(data["xtr"])
    want = jax_ens.decision_function(data["xte"])
    for generic in (False, True):
        port = SubspaceEnsemble(data["masks"], data["proba"], device="cpu", **kw).fit(data["xtr"])
        if generic:
            port._knn_kernel_route = lambda *args: False
        got = port.decision_function(data["xte"])
        assert got.shape == (len(data["xte"]),)
        _close(got, want)


@pytest.mark.parametrize("base", ["knn", "knn_mean"])
def test_predict_threshold_and_pyod_surface_vs_jax(data, route, base):
    jax_ens, port = _pair(data, base=base, k=5)
    labels, want_labels = port.predict(data["xte"]), jax_ens.predict(data["xte"])
    assert np.isclose(port.threshold_, jax_ens.threshold_, rtol=RTOL)
    scores = port.decision_function(np.concatenate([data["xtr"], data["xte"]]),
                                    exclude_self=True)[len(data["xtr"]):]
    _labels_agree(labels, want_labels, scores, port.threshold_)
    assert labels[:4].all(), "the planted outliers are labelled outliers"

    _close(port.decision_scores_, jax_ens.decision_scores_)
    _close(port.decision_function(data["xtr"], exclude_self=True), jax_ens.decision_scores_)
    port_labels = port.labels_
    np.testing.assert_array_equal(port_labels, port.decision_scores_ > port.threshold_)
    _labels_agree(port_labels, jax_ens.labels_, port.decision_scores_, port.threshold_)
    for method in ("linear", "unify"):
        p = port.predict_proba(data["xte"], method=method)
        _close(p, jax_ens.predict_proba(data["xte"], method=method))
        np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("normalize", ["zscore", None])
def test_per_subspace_scores_vs_jax(data, route, normalize):
    jax_ens, port = _pair(data, base="knn_mean", k=4, normalize=normalize)
    got = port.per_subspace_scores(data["xte"])
    assert got.shape == (len(data["masks"]), len(data["xte"]))
    _close(got, jax_ens.per_subspace_scores(data["xte"]))
    _close(port.per_subspace_scores(data["xtr"], exclude_self=True),
           jax_ens.per_subspace_scores(data["xtr"], exclude_self=True))


@pytest.mark.parametrize("aggregation", ["average", "max", "aom", "vote"])
def test_test_chunk_vs_jax_and_one_shot(data, route, aggregation):
    jax_ens, port = _pair(data, base="knn", k=5, aggregation=aggregation, test_chunk=7)
    got = port.decision_function(data["xte"])
    _close(got, jax_ens.decision_function(data["xte"]))
    one_shot = SubspaceEnsemble(data["masks"], data["proba"], base="knn", k=5,
                                aggregation=aggregation, device="cpu").fit(data["xtr"])
    _close(got, one_shot.decision_function(data["xte"]))


def test_jl_dim_vs_jax(data, route):
    rng = np.random.default_rng(1)
    masks = rng.random((9, 4)) < 0.6
    masks[~masks.any(axis=1), 0] = True
    kw = dict(base="knn", k=5, jl_dim=4, jl_seed=3)
    jax_ens = JaxEnsemble(masks, np.ones(9), **kw).fit(data["xtr"])
    port = SubspaceEnsemble(masks, np.ones(9), device="cpu", **kw).fit(data["xtr"])
    np.testing.assert_allclose(port._jl_R.numpy(), np.asarray(jax_ens._jl_R), rtol=1e-6)
    _close(port.decision_function(data["xte"]), jax_ens.decision_function(data["xte"]))
    assert port._train_matrix().shape == (len(data["xtr"]), 4)
    with pytest.raises(ValueError):
        port.decision_function(data["xte"][:, :5])
    with pytest.raises(ValueError):
        SubspaceEnsemble(masks, np.ones(9), jl_dim=5, device="cpu")


@pytest.mark.parametrize("aggregation", ["average", "max", "median"])
def test_zero_probability_masks_vs_jax(data, route, aggregation):
    proba = data["proba"].copy()
    proba[[0, 5, 6]] = 0.0
    masks = data["masks"].copy()
    masks[5] = True  # a mask that would win 'max' had it any weight
    kw = dict(base="knn", k=5, aggregation=aggregation)
    jax_ens = JaxEnsemble(masks, proba, **kw).fit(data["xtr"])
    port = SubspaceEnsemble(masks, proba, device="cpu", **kw).fit(data["xtr"])
    _close(port.decision_function(data["xte"]), jax_ens.decision_function(data["xte"]))


@pytest.mark.parametrize("base", ["knn", "knn_mean"])
def test_generic_streaming_path_vs_jax(data, monkeypatch, base):
    """Past ``STREAM_NTR`` (lowered on both sides to 40) the generic path
    streams the 120 train rows in 32-row blocks. Small-integer rows make
    every distance exact and tie-heavy, and rows duplicated across a block
    boundary give exact zero distances (a near-zero distance formed in two
    summation orders would differ by the square root of its rounding in
    'knn_mean')."""
    rng = np.random.default_rng(5)
    xtr = rng.integers(-2, 3, size=(120, 8)).astype(np.float32)
    xtr[32:48] = xtr[16:32]
    xte = rng.integers(-3, 4, size=(40, 8)).astype(np.float32)
    for mod in (JOD, TOD):
        monkeypatch.setattr(mod, "STREAM_NTR", 40)
        monkeypatch.setattr(mod, "_STREAM_BLOCK", 32)
    monkeypatch.setattr(TOD, "knn_kernel_supported", lambda *args: False)
    kw = dict(base=base, k=6, chunk=5, normalize=None)
    jax_ens = JaxEnsemble(data["masks"], data["proba"], **kw).fit(xtr)
    port = SubspaceEnsemble(data["masks"], data["proba"], device="cpu", **kw).fit(xtr)
    assert TOD._effective_chunk(base, 5, 40, 120, 8) == 5
    _close(port.decision_function(xte), jax_ens.decision_function(xte))
    _close(port.decision_scores_, jax_ens.decision_scores_)

    vals, idx = TOD._masked_knn_streaming(torch.from_numpy(xte), torch.from_numpy(xtr),
                                          torch.from_numpy(data["masks"][1]), 6, False)
    jv, _ = JOD._masked_knn_streaming(xte, xtr, data["masks"][1], 6, False)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    d2 = TOD._masked_sq_dists(torch.from_numpy(xte), torch.from_numpy(xtr),
                              torch.from_numpy(data["masks"][1]))
    np.testing.assert_array_equal(torch.gather(d2, 1, idx).numpy(), vals.numpy())


def test_scorers_and_random_subspaces_vs_jax(data):
    xte, xtr = torch.from_numpy(data["xte"]), torch.from_numpy(data["xtr"])
    chunk = torch.from_numpy(data["masks"][:4])
    for port_fn, jax_fn in ((TOD.knn_scores_masked, JOD.knn_scores_masked),
                            (TOD.mean_dist_scores_masked, JOD.mean_dist_scores_masked)):
        got = port_fn(xtr[:30], xtr, chunk, 5, exclude_self=True)
        assert got.shape == (4, 30)
        for i in range(4):
            _close(got[i].numpy(), jax_fn(data["xtr"][:30], data["xtr"], data["masks"][i], 5,
                                          exclude_self=True))
            _close(port_fn(xte, xtr, chunk[i], 5).numpy(),
                   jax_fn(data["xte"], data["xtr"], data["masks"][i], 5))
    for args in ((8, 20), (8, 20, 3, 2, 5)):
        pm, pp = TOD.random_subspaces(*args)
        jm, jp = JOD.random_subspaces(*args)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pp, jp)


class _MeanDistance:
    """A pyod-style detector: the distance to the training mean."""

    def __init__(self, power=2.0):
        self.power = power

    def get_params(self):
        return {"power": self.power}

    def fit(self, x):
        self.mu = x.mean(axis=0)
        return self

    def decision_function(self, x):
        return (np.abs(x - self.mu) ** self.power).sum(axis=1)


@pytest.mark.parametrize("aggregation", ["average", "max"])
def test_pyod_instance_loop_vs_jax(data, aggregation):
    jax_ens, port = _pair(data, base=_MeanDistance(), aggregation=aggregation)
    _close(port.decision_function(data["xte"]), jax_ens.decision_function(data["xte"]))


def test_ensembles_from_one_jax_model():
    """A tiny JAX ``VGAN_no_kl`` fit; both ensembles built by ``from_model``
    from its (subspaces, proba); the same scores and labels."""
    from vgan_tpu import VGAN_no_kl

    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    Xt = rng.normal(size=(30, 6)).astype(np.float32)
    Xt[:3] *= 4.0
    model = VGAN_no_kl(epochs=2, batch_size=50, verbose=False)
    model.fit(X)
    for base in ("knn", "knn_mean"):
        jax_ens = JaxEnsemble.from_model(model, 50, base=base, k=5).fit(X)
        port = SubspaceEnsemble.from_model(model, 50, base=base, k=5, device="cpu").fit(X)
        np.testing.assert_array_equal(port.subspaces, jax_ens.subspaces)
        np.testing.assert_array_equal(port.proba, jax_ens.proba)
        scores = port.decision_function(Xt)
        _close(scores, jax_ens.decision_function(Xt))
        labels = port.predict(Xt)
        _labels_agree(labels, jax_ens.predict(Xt), scores, port.threshold_)
        assert np.all(np.isfinite(scores))


UNPORTED = [b for b in (*JOD._BASE_SCORERS, *JOD._DIM_BASES, *JOD._PARAM_BASES)
            if b not in (*TOD._BASE_SCORERS, *TOD._DIM_BASES, *TOD._PARAM_BASES)]


def test_unported_bases_and_mesh_raise(data):
    """No base is left to port: every JAX base name constructs. ``mesh=``
    is ported (tests/test_torch_parallel.py): it raises only for an object
    that is not a ``DeviceMesh``, naming ``make_mesh``."""
    assert UNPORTED == []
    for base in (*JOD._BASE_SCORERS, *JOD._DIM_BASES, *JOD._PARAM_BASES):
        assert SubspaceEnsemble(data["masks"], data["proba"], base=base, device="cpu").base == base
    with pytest.raises(TypeError, match="make_mesh"):
        SubspaceEnsemble(data["masks"], data["proba"], mesh=object(), device="cpu")
    for kw in (dict(base="nope"), dict(aggregation="mean"), dict(normalize="rank"),
               dict(aggregation="weighted"), dict(test_chunk=0),
               dict(weights=-np.ones(13))):
        with pytest.raises(ValueError):
            SubspaceEnsemble(data["masks"], data["proba"], device="cpu", **kw)
    with pytest.raises(ValueError):
        SubspaceEnsemble(data["masks"], data["proba"][:5], device="cpu")


def test_guards_and_default_device(data, monkeypatch):
    port = SubspaceEnsemble(data["masks"], data["proba"], k=5, device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        port.decision_function(data["xte"])
    port.fit(data["xtr"][:5])
    with pytest.raises(ValueError, match="k < n_train"):
        port.predict(data["xte"])
    with pytest.raises(ValueError, match="k < n_train"):
        port.decision_function(data["xtr"][:5], exclude_self=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        SubspaceEnsemble(data["masks"], data["proba"])
