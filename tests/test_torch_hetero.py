"""The port's heterogeneous ensemble and score distiller
(``vgan_tpu_torch.ensemble.hetero`` / ``distill``) against ``vgan_tpu``'s on
the same numpy inputs, made from a seed, with ``device="cpu"``.

Tolerances, each with its reason:

- ``_combine`` and the member standardization: float64 on both sides, the
  same formulas in other reduction orders: rtol 1e-12.
- ``ScoreDistiller`` predictions: within ``DISTILL_FRAC`` = 1e-5 of the
  largest prediction. The port forms its features in float32; ``vgan_tpu``
  under x64 (conftest) forms them in float64 (a float32 cosine times a
  float64 scale). Both solve in float64. The features' f32 rounding, a few
  1e-8 relative, reaches the predictions through a ridge-regularized solve:
  3e-7 of the largest prediction at most on these inputs.
- ``ridge_`` (the GCV ``argmin``, a discrete decision) must be equal; each
  case first asserts that ``vgan_tpu``'s two smallest GCV values are more
  than ``GCV_MARGIN_MIN`` = 1e-4 apart (relative), a hundred times what the
  features' rounding moves them, so a near-tie fails loudly instead of
  flipping the pick.
- ``HeterogeneousEnsemble`` scores: float32 member scores formed in other
  summation orders, standardized in float64 and combined: rtol
  ``RTOL_ENS`` = 1e-5 plus ``ATOL_FRAC`` = 1e-5 of the largest score (as
  ``test_torch_ensemble.py``). Labels agree except for rows whose score sits
  within that tolerance of the threshold; a vote agrees except for rows
  where a member's own score sits within it of the member's threshold.
- ``predict_proba``: the scores' tolerance carried through the calibration
  (min-max scaling by the train range; erf of the train-standardized score,
  whose slope is at most 2 / sqrt(pi)).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ensemble.distill as JD
import vgan_tpu.ensemble.hetero as JH
import vgan_tpu_torch.ensemble.distill as TD
import vgan_tpu_torch.ensemble.hetero as TH
from vgan_tpu.ensemble import random_subspaces
from vgan_tpu_torch.ensemble.od import _zscore
from test_torch_bases import one_torch_thread  # noqa: F401  (a fixture)

RTOL64 = 1e-12
DISTILL_FRAC = 1e-5
GCV_MARGIN_MIN = 1e-4
RTOL_ENS = 1e-5
ATOL_FRAC = 1e-5
COMBINATIONS = ["average", "max", "median", "select", "weighted", "vote"]
MEMBERS = [{"base": "knn", "k": 5}, {"base": "lof", "k": 5}, {"base": "ecod"}]
WEIGHTS = [3.0, 1.0, 1.0]


def _atol(want) -> float:
    return ATOL_FRAC * max(float(np.max(np.abs(want))), 1e-30)


def _close(got, want, rtol=RTOL_ENS):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol, atol=_atol(want))


def _near(scores, threshold, scale) -> np.ndarray:
    """Rows whose score sits within the ensemble tolerance of ``threshold``."""
    scores = np.asarray(scores, np.float64)
    return np.abs(scores - threshold) <= RTOL_ENS * abs(threshold) + 2 * ATOL_FRAC * scale


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xtr = rng.normal(size=(40, 8)).astype(np.float32)
    xte = rng.normal(size=(15, 8)).astype(np.float32)
    xte[:3] *= 3.0  # planted outliers
    masks = rng.random((6, 8)) < 0.5
    masks[~masks.any(axis=1), 0] = True
    return dict(xtr=xtr, xte=xte, masks=masks, proba=rng.random(6))


def _pair(data, members=MEMBERS, **kw):
    jax_het = JH.HeterogeneousEnsemble(data["masks"], data["proba"], members=members,
                                       **kw).fit(data["xtr"])
    port = TH.HeterogeneousEnsemble(data["masks"], data["proba"], members=members,
                                    device="cpu", **kw).fit(data["xtr"])
    return jax_het, port


def _vote_exposed(jax_het, x_test) -> np.ndarray:
    """Test rows where some undistilled member's own ``predict`` score sits
    within the tolerance of that member's threshold (its vote may flip)."""
    x_train = jax_het._train_matrix()
    both = np.concatenate([x_train, x_test])
    exposed = np.zeros(len(x_test), bool)
    for i, m in enumerate(jax_het.members):
        if i in jax_het._distillers:
            continue
        s = np.asarray(m.decision_function(both, exclude_self=True), np.float64)
        thr = np.quantile(s[:len(x_train)], 1.0 - m.contamination)
        exposed |= _near(s[len(x_train):], thr, np.abs(s).max())
    return exposed


# ScoreDistiller


def test_median_sq_dist_vs_jax():
    """The mean of the two middle off-diagonal values (never the lower one):
    exact on four points whose 12 squared distances have middle values 9
    and 16; within float32 rounding of JAX's on Gaussian rows."""
    pts = np.array([[0.0], [1.0], [3.0], [7.0]], np.float32)
    assert float(TD._median_sq_dist(torch.from_numpy(pts))) == 12.5
    assert float(JD._median_sq_dist(jnp.asarray(pts))) == 12.5
    x = np.random.default_rng(1).normal(size=(21, 7)).astype(np.float32)
    np.testing.assert_allclose(float(TD._median_sq_dist(torch.from_numpy(x))),
                               float(JD._median_sq_dist(jnp.asarray(x))), rtol=1e-6)


def _distill_data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + x[:, 1] ** 2 + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y, rng.normal(size=(30, d)).astype(np.float32)


def _jax_gcv_margin(dist, x, y) -> float:
    """Relative gap between JAX's two smallest GCV values on its own fit."""
    p = dist._params
    xs = (x - np.asarray(p["x_mu"])) / np.asarray(p["x_sd"])
    ys = ((y - p["y_mu"]) / p["y_sd"]).astype(np.float32)
    ridges = JD._GCV_RIDGES if dist.ridge == "gcv" else (dist.ridge,)
    _, gcvs = JD._rff_fit_gcv(jnp.asarray(xs), jnp.asarray(ys), p["w"], p["b"],
                              jnp.asarray(ridges, jnp.float64), n_cos=dist.n_features)
    g = np.sort(np.asarray(gcvs))
    return float((g[1] - g[0]) / g[0])


def _hold_distiller(jax_d, port_d, x_test):
    want = np.asarray(jax_d.predict(x_test), np.float64)
    got = port_d.predict(x_test)
    assert got.dtype == np.float32 and got.shape == (len(x_test),)
    np.testing.assert_allclose(got, want, rtol=0, atol=DISTILL_FRAC * np.abs(want).max())


@pytest.mark.parametrize("n,d,n_features", [(60, 7, 64), (200, 12, 512), (41, 30, 64),
                                            (2100, 5, 64)])
def test_distiller_vs_jax(n, d, n_features):
    """GCV fit and predictions (n = 2100 takes the 1024-row strided
    subsample for the lengthscale)."""
    x, y, xt = _distill_data(n, d)
    jax_d = JD.ScoreDistiller(n_features=n_features, seed=3).fit(x, y)
    port_d = TD.ScoreDistiller(n_features=n_features, seed=3, device="cpu").fit(x, y)
    assert _jax_gcv_margin(jax_d, x, y) > GCV_MARGIN_MIN
    assert port_d.ridge_ == jax_d.ridge_
    # the same numpy draws, scaled by the median lengthscale (f32 sums in
    # another order: a few ulp)
    np.testing.assert_allclose(port_d._params["w"].numpy(), np.asarray(jax_d._params["w"]),
                               rtol=1e-6)
    _hold_distiller(jax_d, port_d, xt)
    _hold_distiller(jax_d, port_d, x[:50])
    t = torch.from_numpy(xt)
    np.testing.assert_array_equal(port_d._predict_torch(t).numpy(), port_d.predict(xt))


def test_distiller_fixed_knobs():
    """A fixed ridge, lengthscale and three scales (50 features: 16, 16 and
    the remainder 18 to the last scale)."""
    x, y, xt = _distill_data(80, 6, seed=2)
    kw = dict(n_features=50, lengthscale=1.5, scales=(0.5, 1.0, 2.0), ridge=0.01, seed=5)
    jax_d = JD.ScoreDistiller(**kw).fit(x, y)
    port_d = TD.ScoreDistiller(device="cpu", **kw).fit(x, y)
    assert port_d.ridge_ == jax_d.ridge_ == 0.01
    assert port_d._params["w"].shape == (6, 50)
    np.testing.assert_array_equal(port_d._params["w"].numpy(), np.asarray(jax_d._params["w"]))
    _hold_distiller(jax_d, port_d, xt)


@pytest.mark.parametrize("kw", [dict(n_features=0), dict(scales=()), dict(scales=(1.0, -1.0)),
                                dict(ridge=0), dict(ridge=-1), dict(ridge="x"),
                                dict(ridge=0.0), dict(ridge=float("nan"))])
def test_distiller_guards(kw):
    with pytest.raises(ValueError):
        JD.ScoreDistiller(**kw)
    with pytest.raises(ValueError):
        TD.ScoreDistiller(device="cpu", **kw)


def test_distiller_fit_guards():
    x, y, _ = _distill_data(20, 3)
    for args in ((x, y[:10]), (x[:, 0], y)):
        with pytest.raises(ValueError):
            JD.ScoreDistiller().fit(*args)
        with pytest.raises(ValueError):
            TD.ScoreDistiller(device="cpu").fit(*args)
    with pytest.raises(RuntimeError, match="fit"):
        TD.ScoreDistiller(device="cpu").predict(x)


def test_ridge_numpy_scalars_decided():
    """``vgan_tpu``'s ridge check (``distill.py:143-148``) rejects numpy
    scalars other than ``np.float64`` and accepts ``True``. The port takes
    any positive real that is not a bool, stores ``float(ridge)``, and fits
    as ``vgan_tpu`` does with that float (ROADMAP.md Queue 3)."""
    x, y, xt = _distill_data(60, 7)
    for r in (np.float32(0.01), np.int64(1)):
        with pytest.raises(ValueError):
            JD.ScoreDistiller(ridge=r)
        port_d = TD.ScoreDistiller(n_features=64, ridge=r, device="cpu").fit(x, y)
        assert type(port_d.ridge) is float and port_d.ridge_ == float(r)
        jax_d = JD.ScoreDistiller(n_features=64, ridge=float(r)).fit(x, y)
        _hold_distiller(jax_d, port_d, xt)
    assert JD.ScoreDistiller(ridge=True).ridge == 1.0
    with pytest.raises(ValueError):
        TD.ScoreDistiller(ridge=True, device="cpu")


# _combine / standardization


@pytest.mark.parametrize("n_members", [3, 4])
@pytest.mark.parametrize("combination", ["average", "max", "median", "select", "weighted"])
def test_combine_vs_jax(combination, n_members):
    rng = np.random.default_rng(n_members)
    raw = rng.normal(size=(n_members, 30))
    s = JH._standardize(raw)
    np.testing.assert_allclose(_zscore(torch.from_numpy(raw)).numpy(), s, rtol=RTOL64, atol=1e-15)
    weights = rng.random(n_members) if combination == "weighted" else None
    want, wj = JH._combine(s, combination, weights=weights)
    got, wt = TH._combine(torch.from_numpy(s), combination, weights=weights)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL64, atol=1e-15)
    if wj is None:
        assert wt is None
    else:
        np.testing.assert_allclose(wt.numpy(), wj, rtol=RTOL64, atol=1e-15)


def test_select_all_clipped_is_uniform():
    """Members that cancel: the consensus is flat, every correlation clips
    to 0, and 'select' falls back to uniform weights in both packages."""
    a = np.random.default_rng(3).normal(size=20)
    s = np.stack([a, -a])
    want, wj = JH._combine(s, "select")
    got, wt = TH._combine(torch.from_numpy(s), "select")
    np.testing.assert_allclose(wt.numpy(), wj, rtol=RTOL64)
    np.testing.assert_allclose(wt.numpy(), [0.5, 0.5])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-15)


# HeterogeneousEnsemble


@pytest.mark.parametrize("combination,members", [(c, MEMBERS) for c in COMBINATIONS]
                         + [("median", MEMBERS[:1] + MEMBERS[2:])])
def test_hetero_vs_jax(data, combination, members):
    """decision_function, member_scores, member_weights_, predict,
    threshold_, decision_scores_, labels_ and predict_proba (both methods)
    against ``vgan_tpu`` (median also over an even member count)."""
    weights = WEIGHTS[:len(members)] if combination == "weighted" else None
    jax_het, port = _pair(data, members, combination=combination, weights=weights)
    xte = data["xte"]
    want = jax_het.decision_function(xte)
    got = port.decision_function(xte)
    assert got.dtype == np.float32 and got.shape == (len(xte),)
    if combination == "vote":
        exposed = _vote_exposed(jax_het, xte)
        assert exposed.sum() <= 2
        np.testing.assert_array_equal(got[~exposed], want[~exposed])
        assert port.member_weights_ is None
    else:
        _close(got, want)
        _close(port.member_scores(xte), jax_het.member_scores(xte))
        if combination == "select":
            np.testing.assert_allclose(port.member_weights_, jax_het.member_weights_,
                                       rtol=RTOL_ENS, atol=1e-6)
            assert port.member_weights_.dtype == np.float32
    labels, labels_j = port.predict(xte), jax_het.predict(xte)
    if combination == "vote":
        assert port.threshold_ == jax_het.threshold_ == 0.5
        np.testing.assert_array_equal(labels[~exposed], labels_j[~exposed])
    else:
        assert port.threshold_ == pytest.approx(jax_het.threshold_, rel=RTOL_ENS,
                                                abs=_atol(want))
        near = _near(want, jax_het.threshold_, np.abs(want).max())
        np.testing.assert_array_equal(labels[~near], labels_j[~near])
    train_scores = port.decision_scores_
    want_tr = jax_het.decision_scores_
    if combination == "vote":
        exposed_tr = _vote_exposed(jax_het, data["xtr"])
        assert exposed_tr.sum() <= 4
        np.testing.assert_array_equal(train_scores[~exposed_tr], want_tr[~exposed_tr])
    else:
        _close(train_scores, want_tr)
    np.testing.assert_array_equal(port.labels_, (train_scores > port.threshold_).astype(np.int64))
    assert port.threshold_ == float(np.quantile(train_scores, 1.0 - port.contamination))
    tr = np.asarray(jax_het._calibration_scores(xte)[0], np.float64)
    if combination == "vote":  # train fractions: equal away from the exposed rows
        tr_port = port._calibration_scores(xte)[0]
        np.testing.assert_array_equal(tr_port[~exposed_tr], tr[~exposed_tr])
    scale = (RTOL_ENS + 2 * ATOL_FRAC) * np.abs(tr).max()
    for method in ("linear", "unify"):
        tol = (3 * scale / (tr.max() - tr.min()) if method == "linear"
               else 2 / math.sqrt(math.pi) * 3 * scale / (tr.std() * math.sqrt(2)))
        p, pj = port.predict_proba(xte, method), jax_het.predict_proba(xte, method)
        assert p.shape == (len(xte), 2) and p.dtype == np.float32
        if combination != "vote":
            np.testing.assert_allclose(p, pj, atol=tol)
        elif not exposed_tr.any():  # the same calibration: equal away from exposed rows
            np.testing.assert_allclose(p[~exposed], pj[~exposed], atol=1e-6)


def test_member_kwargs_and_pools(data):
    """Member dicts carry their own knobs (no leak to siblings) and their own
    pool; both packages score alike."""
    fb_masks, fb_proba = random_subspaces(8, 9, seed=4)
    members = [{"base": "kde", "kde_bandwidth": 2.5},
               {"base": "knn", "k": 4, "subspaces": fb_masks, "proba": fb_proba},
               {"base": "ecod"}]
    jax_het, port = _pair(data, members)
    assert port.members[0].kde_bandwidth == 2.5
    assert port.members[2].kde_bandwidth == 1.0  # the default, not leaked
    assert port.members[1].subspaces.shape == (9, 8)
    assert port.members[0].subspaces.shape == data["masks"].shape
    assert all(m.device == torch.device("cpu") for m in port.members)
    _close(port.decision_function(data["xte"]), jax_het.decision_function(data["xte"]))


def test_test_chunk_reaches_members(data):
    jax_het, port = _pair(data, test_chunk=4)
    assert all(m.test_chunk == 4 for m in port.members)
    got = port.decision_function(data["xte"])
    _close(got, jax_het.decision_function(data["xte"]))
    one = TH.HeterogeneousEnsemble(data["masks"], data["proba"], members=MEMBERS,
                                   device="cpu").fit(data["xtr"])
    _close(got, one.decision_function(data["xte"]))


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(5)
    xtr = rng.normal(size=(60, 30)).astype(np.float32)
    xte = rng.normal(size=(20, 30)).astype(np.float32)
    xte[:4] += 6.0
    masks = rng.random((5, 30)) < 0.4
    masks[~masks.any(axis=1), 0] = True
    return dict(xtr=xtr, xte=xte, masks=masks, proba=np.full(5, 0.2))


JL = {"base": "knn", "k": 5, "jl_dim": 6, "jl_seed": 1}


def test_jl_member_second(wide):
    jax_het, port = _pair(wide, [{"base": "knn", "k": 5}, JL])
    assert port.members[1].subspaces.shape == (1, 6)
    assert port._train_matrix().shape == (60, 30)
    _close(port.decision_function(wide["xte"]), jax_het.decision_function(wide["xte"]))
    labels, labels_j = port.predict(wide["xte"]), jax_het.predict(wide["xte"])
    s = jax_het.decision_function(np.concatenate([wide["xtr"], wide["xte"]]), exclude_self=True)
    near = _near(s[60:], jax_het.threshold_, np.abs(s).max())
    np.testing.assert_array_equal(labels[~near], labels_j[~near])


def test_jl_member_first_decided(wide):
    """``vgan_tpu``'s ``predict`` reads member 0's train matrix
    (``hetero.py:381``), projected for a JL member, and raises. The port
    reads the original-space matrix: its JL-first ``predict`` equals
    ``vgan_tpu``'s with the members swapped, under 'average' (symmetric in
    its members); decision_function agrees in the original order."""
    members = [JL, {"base": "knn", "k": 5}]
    jax_het, port = _pair(wide, members)
    with pytest.raises(ValueError):
        jax_het.predict(wide["xte"])
    _close(port.decision_function(wide["xte"]), jax_het.decision_function(wide["xte"]))
    swapped, _ = _pair(wide, members[::-1])
    labels, labels_j = port.predict(wide["xte"]), swapped.predict(wide["xte"])
    assert port.threshold_ == pytest.approx(swapped.threshold_, rel=RTOL_ENS, abs=1e-5)
    both = np.concatenate([wide["xtr"], wide["xte"]])
    s = swapped.decision_function(both, exclude_self=True)
    _close(port.decision_function(both, exclude_self=True), s)
    near = _near(s[60:], swapped.threshold_, np.abs(s).max())
    np.testing.assert_array_equal(labels[~near], labels_j[~near])
    assert labels[:4].all()  # the shifted rows


def test_distill_vote_and_refit(data):
    """distill() of every member (train scores with exclude_self for the
    neighbour members, seed + i), the distilled scores, a vote over
    distilled members, and refit clearing the distillers."""
    jax_het, port = _pair(data)
    xte = data["xte"]
    jax_het.distill(n_features=64)
    port.distill(n_features=64)
    assert port.distilled_members_ == jax_het.distilled_members_ == [0, 1, 2]
    for i in range(3):
        jd, pd = jax_het._distillers[i], port._distillers[i]
        assert pd.seed == i and pd.ridge_ == jd.ridge_ and pd.device == torch.device("cpu")
        _hold_distiller(jd, pd, xte)
    _close(port.decision_function(xte), jax_het.decision_function(xte))
    _close(port.predict_proba(xte)[:, 1], jax_het.predict_proba(xte)[:, 1], rtol=1e-4)
    port.combination = jax_het.combination = "vote"
    exposed = np.zeros(len(xte), bool)
    for i in range(3):  # a distilled vote flips only near its train-score quantile
        jd = jax_het._distillers[i]
        s_tr = np.asarray(jd.predict(data["xtr"]), np.float64)
        thr = np.quantile(s_tr, 1.0 - jax_het.contamination)
        s = np.asarray(jd.predict(xte), np.float64)
        exposed |= np.abs(s - thr) <= 2 * DISTILL_FRAC * np.abs(s_tr).max()
    got, want = port.decision_function(xte), jax_het.decision_function(xte)
    np.testing.assert_array_equal(got[~exposed], want[~exposed])
    assert exposed.sum() <= 2
    port.distill(members=[1], n_features=32)
    assert port._distillers[1].n_features == 32
    port.fit(data["xtr"])
    assert port.distilled_members_ == [] and port._decision_scores is None


@pytest.mark.parametrize("kw", [
    dict(combination="trimmed_mean"), dict(members=[]), dict(combination="weighted"),
    dict(weights=[1.0, 1.0]), dict(weights=[1.0, -1.0, 1.0]), dict(weights=[0.0, 0.0, 0.0]),
    dict(members=[{"base": "knn", "subspaces": np.ones((2, 8), bool)}]),
    dict(members=[{"base": "knn", "proba": np.ones(2)}]),
])
def test_constructor_guards(data, kw):
    """Every guard raises the error type of ``vgan_tpu``'s."""
    kw = {"members": MEMBERS, **kw}
    with pytest.raises(ValueError):
        JH.HeterogeneousEnsemble(data["masks"], data["proba"], **kw)
    with pytest.raises(ValueError):
        TH.HeterogeneousEnsemble(data["masks"], data["proba"], device="cpu", **kw)


def test_signatures_and_no_card(data, monkeypatch):
    """The constructors take ``vgan_tpu``'s arguments in its order, then
    ``device``; without a card and without ``device="cpu"`` they raise."""
    for jcls, tcls in ((JH.HeterogeneousEnsemble, TH.HeterogeneousEnsemble),
                       (JD.ScoreDistiller, TD.ScoreDistiller)):
        jp = list(inspect.signature(jcls).parameters.values())
        tp = list(inspect.signature(tcls).parameters.values())
        named = [p for p in jp if p.kind != p.VAR_KEYWORD]
        assert [(p.name, p.default) for p in tp[:len(named)]] == [
            (p.name, p.default) for p in named]
        assert tp[len(named)].name == "device" and tp[len(named)].default is None
        assert [p.name for p in tp[len(named) + 1:]] == [p.name for p in jp[len(named):]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TH.HeterogeneousEnsemble(data["masks"], data["proba"])
    with pytest.raises(RuntimeError):
        TD.ScoreDistiller()
