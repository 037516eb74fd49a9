"""The port's covariance, spectral, clustering and density bases (pca, kde,
mcd, kpca, cblof, gmm) against ``vgan_tpu.ensemble.od``: each scorer in
float64 on the same numpy inputs, vmapped over the masks on the JAX side as
its ensemble runs it, batched over the chunk on the port's.

Tolerances, float64 on both sides: kde 1e-9 (the same operations, a few
ulp); pca, kpca, mcd, cblof and gmm 1e-8 (two LAPACKs' ``eigh`` / Cholesky,
and for cblof, gmm and mcd a few dozen iterations of them).

The centroid init of cblof and gmm draws from JAX's PRNG, which the port
cannot reproduce: the port takes its draws as arguments
(:class:`~vgan_tpu_torch.ensemble.od.CentroidDraws`), and these tests feed
it JAX's own, rebuilt from ``jax.random.PRNGKey(seed)`` in
``_init_centroids``' split order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ensemble.od as JOD
import vgan_tpu_torch.ensemble.od as TOD
from vgan_tpu_torch import SubspaceEnsemble

RTOL_KDE = 1e-9
RTOL_LAPACK = 1e-8


def _data(seed=0, ntr=50, nt=20, d=7, n_masks=9):
    """Gaussian rows (a few test rows scaled out, one duplicated from the
    train rows) and masks with an all-zero, an all-column and a one-column
    mask among them."""
    rng = np.random.default_rng(seed)
    xtr, xte = rng.normal(size=(ntr, d)), rng.normal(size=(nt, d))
    xte[:3] *= 3.0
    xte[5] = xtr[5]
    masks = rng.random((n_masks, d)) < 0.5
    masks[0] = False
    masks[1] = True
    masks[2] = False
    masks[2, 3] = True
    return xte, xtr, masks


def _port(name, xte, xtr, masks, **kw):
    fn = getattr(TOD, f"{name}_scores_masked")
    return fn(torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks), 0, **kw)


def _jax(name, xte, xtr, masks, **kw):
    fn = functools.partial(getattr(JOD, f"{name}_scores_masked"), k=0, **kw)
    batched = jax.jit(jax.vmap(lambda m: fn(jnp.asarray(xte), jnp.asarray(xtr), m)))
    return np.asarray(batched(jnp.asarray(masks, jnp.float64)))


def _held(name, rtol, xte, xtr, masks, port_kw=None, **kw):
    """The port's (masks, nt) float64 scores against JAX's; returns them."""
    got = _port(name, xte, xtr, masks, **dict(kw, **(port_kw or {})))
    assert got.shape == (len(masks), len(xte)) and got.dtype == torch.float64
    assert torch.all(torch.isfinite(got))
    want = _jax(name, xte, xtr, masks, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))
    one = _port(name, xte, xtr, masks[4], **dict(kw, **(port_kw or {})))
    assert one.shape == (len(xte),)
    np.testing.assert_allclose(one.numpy(), got[4].numpy(), rtol=1e-12, atol=1e-12)
    return got


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(n_components=4, n_selected=2),
    dict(n_components=3, standardize=False),
    dict(n_selected=1, weighted=False),
])
def test_pca_vs_jax(cfg):
    """Masks of exactly two varying standardized columns are left out: their
    covariance is [[s, r], [r, s]], whose eigenvectors (1, +-1) / sqrt(2)
    tie ``svd_flip``'s largest coefficient in exact arithmetic, so each
    LAPACK's rounding picks the sign (in the JAX package as in the port)."""
    xte, xtr, masks = _data()
    xtr[:, 0] = 2.0  # a constant column: scale 1
    masks = masks[masks.sum(axis=1) != 2]
    got = _held("pca", RTOL_LAPACK, xte, xtr, masks, **cfg)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)  # no component survives


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("bandwidth", [1.0, 0.6])
def test_kde_vs_jax(bandwidth, exclude_self):
    xte, xtr, masks = _data(1)
    xte[:10] = xtr[:10]
    _held("kde", RTOL_KDE, xte, xtr, masks, bandwidth=bandwidth, exclude_self=exclude_self)


@pytest.fixture
def streamed(monkeypatch):
    """``STREAM_NTR`` lowered to 40 on both sides, 16-row train blocks: 70
    train rows stream in five blocks (JAX pads the last one)."""
    for mod in (JOD, TOD):
        monkeypatch.setattr(mod, "STREAM_NTR", 40)
        monkeypatch.setattr(mod, "_STREAM_BLOCK", 16)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_kde_streamed_vs_jax(streamed, exclude_self):
    xte, xtr, masks = _data(2, ntr=70)
    xte[:12] = xtr[:12]
    assert TOD._stream_block(len(xte)) == JOD._stream_block(len(xte)) == 16
    got = _held("kde", RTOL_KDE, xte, xtr, masks, exclude_self=exclude_self)
    dense = TOD._kde_log_kernel_sum(torch.from_numpy(xte), torch.from_numpy(xtr),
                                    torch.from_numpy(masks).double(), 1.0, exclude_self)
    TOD.STREAM_NTR = 16384  # the dense logsumexp on the same rows (restored by the fixture)
    want = TOD._kde_log_kernel_sum(torch.from_numpy(xte), torch.from_numpy(xtr),
                                   torch.from_numpy(masks).double(), 1.0, exclude_self)
    np.testing.assert_allclose(dense.numpy(), want.numpy(), rtol=RTOL_KDE)
    assert torch.all(torch.isfinite(got))


@pytest.mark.parametrize("support_fraction", [0.0, 0.7])
def test_mcd_vs_jax(support_fraction):
    xte, xtr, masks = _data(3, ntr=60)
    xtr[:6] += 6.0  # contamination the robust fit should discard
    _held("mcd", RTOL_LAPACK, xte, xtr, masks, support_fraction=support_fraction, seed=2)


def test_mcd_starts_and_steps_vs_jax():
    xte, xtr, masks = _data(4)
    _held("mcd", RTOL_LAPACK, xte, xtr, masks[:5], n_starts=3, c_steps=4, seed=5)


def test_chi2_tables_vs_scipy():
    """The mcd tables over dof 1..10240 against ``scipy.stats.chi2`` (the
    JAX package's recipe, ``od.py:2141-2157``), at rtol 1e-10."""
    chi2 = pytest.importorskip("scipy.stats").chi2
    d, ntr = 10240, 20000
    dofs = np.arange(1, d + 1)

    def consistency(alpha):
        q = chi2.ppf(np.clip(alpha, 0.0, 1.0), dofs)
        return alpha / np.where(np.isfinite(q), chi2.cdf(q, dofs + 2), 1.0)

    for fraction in (0.0, 0.7):
        h, corr_raw, chi2_rw, c_alpha = TOD._mcd_tables(ntr, d, fraction)
        want_h = (np.full(d, int(fraction * ntr)) if fraction > 0 else
                  np.minimum(np.ceil(0.5 * (ntr + dofs + 1)).astype(int), ntr))
        np.testing.assert_array_equal(h, want_h)
        np.testing.assert_allclose(corr_raw, consistency(want_h / ntr), rtol=1e-10)
        np.testing.assert_allclose(chi2_rw, chi2.ppf(0.975, dofs), rtol=1e-10)
        np.testing.assert_allclose(c_alpha, consistency(np.full(d, 0.975)), rtol=1e-10)
    # the support reaching every row (h = n): the quantile is infinite and the
    # factor is alpha itself
    h, corr_raw, _, _ = TOD._mcd_tables(30, 40, 0.0)
    np.testing.assert_allclose(corr_raw[h == 30], 1.0)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(gamma=0.5, n_components=3),
    dict(sampling=True, subset_size=15, seed=3),
])
def test_kpca_vs_jax(cfg):
    xte, xtr, masks = _data(5, ntr=40)
    _held("kpca", RTOL_LAPACK, xte, xtr, masks, **cfg)


def jax_centroid_draws(n, n_clusters, method, seed, dtype=jnp.float64):
    """JAX's draws of ``_init_centroids`` as port draws: the 'rows' choice,
    or the first row and each step's Gumbel noise from the same key splits.
    Asserts that the Gumbel-max form reproduces ``jax.random.categorical``."""
    key = jax.random.PRNGKey(seed)
    if method == "rows":
        rows = jax.random.choice(key, n, (n_clusters,), replace=False)
        return TOD.CentroidDraws(rows=torch.from_numpy(np.asarray(rows).astype(np.int64)))
    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    logits = jnp.log(jnp.asarray(np.random.default_rng(seed).random(n), dtype) + 1e-12)
    noise = []
    for _ in range(1, n_clusters):
        key, kd = jax.random.split(key)
        g = jax.random.gumbel(kd, (n,), dtype)
        assert int(jnp.argmax(logits + g)) == int(jax.random.categorical(kd, logits))
        noise.append(np.asarray(g))
    return TOD.CentroidDraws(first=torch.tensor(int(first)),
                             gumbel=torch.from_numpy(np.stack(noise).astype(np.float64)))


@pytest.mark.parametrize("init", ["rows", "kmeans++"])
def test_init_centroids_vs_jax(init):
    _, xtr, masks = _data(6)
    m = torch.from_numpy(masks).double()
    xm = torch.from_numpy(xtr)[None] * m[:, None, :]
    draws = jax_centroid_draws(len(xtr), 5, init, 4)
    got = TOD._init_centroids(xm, 5, init, draws)
    want = jax.vmap(lambda mk: JOD._init_centroids(jnp.asarray(xtr) * mk[None, :], 5, 4, init))(
        jnp.asarray(masks, jnp.float64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(init="kmeans++", n_clusters=5, kmeans_iter=12, cluster_seed=3),
    dict(alpha=0.6, beta=2.0, n_clusters=6),
])
def test_cblof_vs_jax(cfg):
    xte, xtr, masks = _data(7)
    xtr[:25] += 3.0  # two blobs of equal size: tied cluster sizes are common
    n_clusters = cfg.get("n_clusters", 8)
    draws = jax_centroid_draws(len(xtr), n_clusters, cfg.get("init", "rows"),
                               cfg.get("cluster_seed", 0))
    _held("cblof", RTOL_LAPACK, xte, xtr, masks, port_kw=dict(draws=draws), **cfg)


def test_cblof_large_mask_vs_jax():
    """The large/small rule on hand-made sizes: ties, empty clusters, each
    rule alone and neither."""
    counts = np.array([[10, 10, 10, 10, 10, 0], [40, 5, 3, 2, 0, 0], [20, 20, 5, 5, 0, 0],
                       [9, 9, 9, 9, 7, 7], [30, 30, 0, 0, 0, 0], [25, 10, 10, 5, 0, 0]],
                      np.float64)
    for alpha, beta in ((0.9, 5.0), (0.5, 2.0), (0.95, 1.5)):
        got = TOD._cblof_large_mask(torch.from_numpy(counts), 50, alpha, beta)
        want = jax.vmap(lambda c: JOD._cblof_large_mask(c, 50, alpha, beta))(jnp.asarray(counts))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("covariance", ["diag", "full"])
@pytest.mark.parametrize("init", ["rows", "kmeans++"])
def test_gmm_vs_jax(covariance, init):
    xte, xtr, masks = _data(8)
    xtr[:20] += 4.0
    draws = jax_centroid_draws(len(xtr), 3, init, 1)
    _held("gmm", RTOL_LAPACK, xte, xtr, masks, port_kw=dict(draws=draws), n_components=3,
          em_iter=12, component_seed=1, init=init, covariance=covariance)


def test_port_draws_are_seeded_and_shared():
    """Without draws the port takes :func:`draw_centroids` of the seed: the
    same for every call, other for another seed."""
    xte, xtr, masks = _data(9)
    te, tr, mk = torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks)
    for init in ("rows", "kmeans++"):
        a = TOD.cblof_scores_masked(te, tr, mk, n_clusters=4, cluster_seed=2, init=init)
        b = TOD.cblof_scores_masked(te, tr, mk, n_clusters=4, init=init,
                                    draws=TOD.draw_centroids(len(xtr), 4, init, 2))
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        draws = TOD.draw_centroids(len(xtr), 4, init, 3)
        other = TOD.draw_centroids(len(xtr), 4, init, 2)
        assert not all(torch.equal(x, y) for x, y in zip(draws, other) if x is not None)
    rows = TOD.draw_centroids(len(xtr), 4, "rows", 0).rows
    assert len(set(rows.tolist())) == 4


def test_scorer_guards():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 3)))
    mask = torch.ones(3, dtype=torch.float64)
    cases = [
        (TOD.pca_scores_masked, x[:1], {}, "at least 2 train rows"),
        (TOD.mcd_scores_masked, x[:1], {}, "at least 2 train rows"),
        (TOD.kpca_scores_masked, x[:1], {}, "at least 2 fit rows"),
        (TOD.cblof_scores_masked, x, dict(n_clusters=1), "n_clusters >= 2"),
        (TOD.cblof_scores_masked, x, dict(n_clusters=7), "n_clusters <= n_train"),
        (TOD.cblof_scores_masked, x, dict(n_clusters=2, alpha=0.0), "alpha in"),
        (TOD.cblof_scores_masked, x, dict(n_clusters=2, beta=0.5), "beta >= 1"),
        (TOD.cblof_scores_masked, x, dict(n_clusters=2, init="random"), "cluster_init"),
        (TOD.gmm_scores_masked, x, dict(n_components=0), "n_components >= 1"),
        (TOD.gmm_scores_masked, x, dict(n_components=7), "n_components <= n_train"),
        (TOD.gmm_scores_masked, x, dict(covariance="tied"), "covariance"),
    ]
    for fn, xtr, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(x, xtr, mask, 0, **kw)


@pytest.mark.parametrize("kw", [
    dict(kde_bandwidth=0.0), dict(cluster_alpha=1.5), dict(cluster_beta=0.5),
    dict(base="cblof", n_clusters=1), dict(base="gmm", n_clusters=0),
    dict(cluster_init="random"), dict(gmm_covariance="tied"), dict(subset_size=0),
    dict(subset_size=True), dict(support_fraction=1.5), dict(support_fraction=True),
    dict(mcd_starts=0), dict(mcd_steps=2.0), dict(kpca_n_components=-1),
    dict(kpca_gamma=-0.1), dict(pca_n_components=-1), dict(pca_n_selected=1.0),
])
def test_ensemble_knob_guards_follow_jax(kw):
    from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble

    masks, proba = np.ones((2, 3), bool), np.ones(2)
    kw = dict(dict(base="knn"), **kw)
    with pytest.raises(ValueError) as want:
        JaxEnsemble(masks, proba, **kw)
    with pytest.raises(ValueError) as got:
        SubspaceEnsemble(masks, proba, device="cpu", **kw)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("base,kw", [
    ("pca", {}), ("kpca", dict(kpca_n_components=4)),
    ("kpca", dict(kpca_sampling=True, subset_size=12, kpca_n_components=4)),
    ("mcd", dict(mcd_starts=3)), ("cblof", dict(n_clusters=4)),
    ("gmm", dict(n_clusters=3)), ("gmm", dict(n_clusters=3, gmm_covariance="full",
                                            cluster_init="kmeans++")),
    ("kde", dict(kde_bandwidth=0.8)),
])
def test_scores_do_not_depend_on_the_chunk(base, kw):
    """The ensemble's float32 raw scores at chunk 1 and chunk 9. kpca keeps
    its leading four components here: on these masks of one to five
    columns the kernel spectrum falls past ``1e-5 * lambda_max`` within a
    few components, where float32 ``eigh`` noise (about n 2^-24 lambda_max)
    is a sizeable part of the eigenvalue it divides by, so the batch size's
    own rounding moves the default score by 1e-3 (in the JAX package too);
    :func:`test_kpca_batching_float64` holds every component."""
    xte, xtr, masks = _data(10, ntr=40)
    raws = []
    for chunk in (1, 9):
        ens = SubspaceEnsemble(masks, np.ones(len(masks)), base=base, chunk=chunk, device="cpu",
                               **kw).fit(xtr.astype(np.float32))
        raws.append(ens._raw_per_subspace(xte.astype(np.float32)))
    assert np.all(np.isfinite(raws[0]))
    np.testing.assert_allclose(raws[0], raws[1], rtol=1e-6, atol=1e-6 * np.abs(raws[0]).max())


@pytest.mark.parametrize("cfg", [dict(), dict(sampling=True, subset_size=12)])
def test_kpca_batching_float64(cfg):
    """kpca with every component, float64: one call over nine masks equals
    nine one-mask calls."""
    xte, xtr, masks = _data(10, ntr=40)
    whole = _port("kpca", xte, xtr, masks, **cfg)
    for i, mk in enumerate(masks):
        np.testing.assert_allclose(_port("kpca", xte, xtr, mk, **cfg).numpy(),
                                   whole[i].numpy(), rtol=1e-10, atol=1e-12)


def test_decision_margins():
    """``margins`` receives one (c,) tensor a decision stage, each >= 0, and
    an exact tie gives 0: a train row midway between the two initial
    centroids (cblof), two standardized columns (pca's tied coefficients)."""
    xte, xtr, masks = _data(11)
    te, tr, mk = torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks)
    for name, kw, stages in (("cblof", dict(n_clusters=3, kmeans_iter=4), 5),
                             ("mcd", dict(n_starts=2, c_steps=3), 1), ("pca", {}, 1)):
        margins = []
        plain = getattr(TOD, f"{name}_scores_masked")(te, tr, mk, **kw)
        got = getattr(TOD, f"{name}_scores_masked")(te, tr, mk, margins=margins, **kw)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        assert len(margins) == stages and all(m.shape == (len(masks),) for m in margins)
        assert all(bool(torch.all(m >= 0)) for m in margins)
    line = torch.tensor([[-1.0], [0.0], [1.0], [3.0], [-3.0]], dtype=torch.float64)
    margins = []
    TOD.cblof_scores_masked(line, line, torch.ones(1, dtype=torch.float64), n_clusters=2,
                            kmeans_iter=1, draws=TOD.CentroidDraws(rows=torch.tensor([0, 2])),
                            margins=margins)
    assert float(margins[0]) == 0.0 and float(margins[1]) > 0.0
    two = np.zeros((1, 7), bool)
    two[0, [1, 4]] = True
    margins = []
    _port("pca", xte, xtr, two, margins=margins)
    assert float(margins[0][0]) < 1e-12
