"""The port's isolation forest (``vgan_tpu_torch.ensemble.iforest``) against
``vgan_tpu.ensemble.iforest``.

The port's builder and scorer are deterministic functions of the draws, so
they are held to the JAX forest on the JAX package's own draws, rebuilt here
from ``PRNGKey(0)`` with its key schedule. The port draws from a seeded CPU
``torch.Generator`` instead, so at the ensemble level the two forests are
independent samples of one algorithm and are compared statistically.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ensemble.iforest as JIF
import vgan_tpu_torch.ensemble.iforest as TIF
from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble
from vgan_tpu_torch import SubspaceEnsemble

# f32 on both sides with the same splits: the path lengths are the same
# small integers plus c(size) terms, averaged over trees in another order.
RTOL_DRAWS = 1e-6


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_tree_draws(logits, n_train: int, n_trees: int, psi: int, depth: int):
    def one_tree(tree_key):
        k_sub, k_feat, k_thr = jax.random.split(tree_key, 3)
        sub = jax.random.choice(k_sub, n_train, (psi,), replace=psi > n_train)
        feats = [jax.random.categorical(jax.random.fold_in(k_feat, level),
                                        jnp.broadcast_to(logits, (2**level, logits.shape[0])))
                 for level in range(depth)]
        us = [jax.random.uniform(jax.random.fold_in(k_thr, level), (2**level,))
              for level in range(depth)]
        return sub, jnp.concatenate(feats), jnp.concatenate(us)

    return jax.vmap(one_tree)(jax.random.split(jax.random.PRNGKey(0), n_trees))


def jax_draws(n_train: int, n_trees: int, psi: int, mask: np.ndarray):
    """The JAX forest's draws for one mask, with ``_iforest_impl`` /
    ``_fit_tree``'s key schedule: ``PRNGKey(0)`` split per tree (vmapped),
    each tree key split in 3 (subsample, feature, threshold), ``choice`` of
    the subsample, then per level ``categorical`` over the mask's logits and
    ``uniform`` on ``fold_in(key, level)``. Returns the port's operands:
    subsample (T, psi), features (1, T, nodes), threshold uniforms (T, nodes)."""
    psi, depth = TIF.forest_shape(n_train, psi)
    logits = jnp.where(jnp.asarray(mask, jnp.float32) > 0, 0.0, -jnp.inf)
    sub, feat, u = _jax_tree_draws(logits, n_train, n_trees, psi, depth)
    return (torch.from_numpy(np.asarray(sub).astype(np.int64)),
            torch.from_numpy(np.asarray(feat).astype(np.int64))[None],
            torch.from_numpy(np.array(u)))


def _planted(seed=0, n_in=300, n_out=20, d=8):
    rng = np.random.default_rng(seed)
    xtr = rng.normal(size=(n_in, d)).astype(np.float32)
    inliers = rng.normal(size=(60, d)).astype(np.float32)
    outliers = rng.normal(size=(n_out, d)).astype(np.float32) * 1.5 + 5.0
    return xtr, np.concatenate([inliers, outliers]), np.r_[np.zeros(60), np.ones(n_out)] > 0


def _auc(scores, is_out):
    pos, neg = scores[is_out][:, None], scores[~is_out][None, :]
    return float(np.mean((pos > neg) + 0.5 * (pos == neg)))


def _spearman(a, b):
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1])


@pytest.mark.parametrize("kind", ["all", "partial", "single", "all-zero"])
def test_builder_and_scorer_on_jax_draws(kind):
    """The port's forest grown from the JAX forest's draws scores as
    ``iforest_scores_masked`` does: duplicated rows and out-of-range test
    rows included, psi below n_train."""
    rng = np.random.default_rng(1)
    xtr = rng.normal(size=(40, 6)).astype(np.float32)
    xtr[20:26] = xtr[:6]
    xte = np.concatenate([xtr[:10], rng.normal(size=(14, 6)).astype(np.float32) * 3.0])
    mask = {"all": np.ones(6, bool), "partial": np.array([1, 0, 1, 1, 0, 1], bool),
            "single": np.eye(6, dtype=bool)[4], "all-zero": np.zeros(6, bool)}[kind]
    n_trees, psi = 12, 32
    sub, feat, thr_u = jax_draws(len(xtr), n_trees, psi, mask)
    assert torch.all(feat[0] == 0) if kind == "all-zero" else torch.all(
        torch.from_numpy(mask)[feat])
    got = TIF.iforest_from_draws(torch.from_numpy(xte), torch.from_numpy(xtr), sub, feat, thr_u)
    want = JIF.iforest_scores_masked(jnp.asarray(xte), jnp.asarray(xtr), jnp.asarray(mask),
                                     n_trees=n_trees, psi=psi)
    assert got.shape == (1, len(xte))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=RTOL_DRAWS)


def test_split_features_uniform_over_selected_columns():
    masks = torch.tensor([[1, 0, 1, 1, 0, 0, 1], [0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 1, 0],
                          [1, 1, 1, 1, 1, 1, 1]], dtype=torch.float32)
    u = torch.rand((50, 255), generator=torch.Generator().manual_seed(3))
    feat = TIF.split_features(u, masks)
    assert feat.shape == (4, 50, 255) and feat.dtype == torch.int64
    counts = [torch.bincount(f.reshape(-1), minlength=7) for f in feat]
    np.testing.assert_array_equal((counts[0] > 0).numpy(), masks[0].bool().numpy())
    assert counts[1][0] == 50 * 255 and counts[2][5] == 50 * 255  # all-zero: column 0
    assert counts[3].min() > 50 * 255 / 7 * 0.9  # uniform over all seven
    # rank r of u in [r / n, (r + 1) / n) picks the r-th selected column
    edge = torch.tensor([[0.0, 0.2499, 0.25, 0.75, 0.9999999]])
    np.testing.assert_array_equal(TIF.split_features(edge, masks[:1])[0, 0].numpy(),
                                  [0, 0, 2, 6, 6])


def test_draws_are_seeded_shared_and_on_the_cpu():
    a = TIF.draw_iforest(300, 10, seed=5)
    b = TIF.draw_iforest(300, 10, seed=5)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.device.type == "cpu"
    assert a.subsample.shape == (10, 256) and a.feature_u.shape == (10, 255)
    for row in a.subsample:
        assert len(torch.unique(row)) == 256 and int(row.max()) < 300
    assert TIF.forest_shape(100) == (100, 7) and TIF.forest_shape(2) == (2, 1)
    xtr, xte, _ = _planted(2, n_in=120)
    te, tr = torch.from_numpy(xte), torch.from_numpy(xtr)
    masks = torch.from_numpy(np.random.default_rng(2).random((5, 8)) < 0.5)
    chunk = TIF.iforest_scores_masked(te, tr, masks, n_trees=20)
    for i in range(5):
        one = TIF.iforest_scores_masked(te, tr, masks[i], n_trees=20)
        np.testing.assert_allclose(one.numpy(), chunk[i].numpy(), rtol=1e-6)
    assert not torch.equal(chunk, TIF.iforest_scores_masked(te, tr, masks, n_trees=20, seed=6))


def test_full_space_scores_detect_planted_outliers():
    xtr, xte, is_out = _planted(0)
    scores = TIF.iforest_scores(xte, xtr, n_trees=100, device="cpu")
    assert scores.shape == (len(xte),) and scores.dtype == np.float32
    assert np.all((scores > 0) & (scores <= 1))
    assert _auc(scores, is_out) > 0.95


def test_masked_forest_ignores_unselected_features():
    rng = np.random.default_rng(3)
    xtr = rng.normal(size=(200, 6)).astype(np.float32)
    xte = rng.normal(size=(40, 6)).astype(np.float32)
    xte[:10, 4:] += 50.0  # outliers only in the unselected features
    mask = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)
    scores = TIF.iforest_scores_masked(torch.from_numpy(xte), torch.from_numpy(xtr), mask)
    assert _auc(scores.numpy(), np.arange(40) < 10) < 0.7


def test_ensemble_vs_jax_statistically():
    """``SubspaceEnsemble(base='iforest')`` against the JAX ensemble on the
    same masks: independent draws, so rank agreement and detection."""
    xtr, xte, is_out = _planted(4, n_in=120)
    rng = np.random.default_rng(4)
    masks = rng.random(size=(6, 8)) < 0.6
    masks[:, 0] |= ~masks.any(axis=1)
    kw = dict(base="iforest", n_trees=64, chunk=4)
    port = SubspaceEnsemble(masks, np.full(6, 1 / 6), device="cpu", **kw).fit(xtr)
    jax_ens = JaxEnsemble(masks, np.full(6, 1 / 6), **kw).fit(xtr)
    got, want = port.decision_function(xte), jax_ens.decision_function(xte)
    assert np.all(np.isfinite(got)) and _auc(got, is_out) > 0.9 and _auc(want, is_out) > 0.9
    assert _spearman(got, want) > 0.85
    # chunks share the draws: the chunk size does not move a score
    one = SubspaceEnsemble(masks, np.full(6, 1 / 6), device="cpu", base="iforest", n_trees=64,
                           chunk=1).fit(xtr)
    np.testing.assert_allclose(one.decision_function(xte), got, rtol=1e-5, atol=1e-6)
    labels = port.predict(xte)
    assert labels[is_out].mean() > 0.9 and port.labels_.shape == (len(xtr),)
    # iforest includes the point (exclude_self is no-op for it, as in pyod)
    np.testing.assert_array_equal(port.decision_scores_, port.decision_function(xtr))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xtr, xte, _ = _planted(0, n_in=50)
    with pytest.raises(RuntimeError, match="cpu"):
        TIF.iforest_scores(xte, xtr)
    assert math.isclose(float(TIF._c_factor(torch.tensor(256.0))),
                        float(JIF._c_factor(jnp.asarray(256.0))), rel_tol=1e-6)
