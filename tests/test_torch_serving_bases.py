"""Every native base of the port's ``SubspaceEnsemble`` through
``vgan_tpu_torch.serving``: ``export_ensemble_scorer`` and
``export_per_subspace_scorer``, each loaded program held to the live port
call on the CPU at two batch sizes (rtol ``RTOL`` = 1e-5, atol ``ATOL`` =
1e-6: knn and knn_mean take the fused route live and the generic chunked
route in the program, float32 in other summation orders; every other base
runs the same ops, and agrees to the bit here), called twice for the same
bits.

Each export runs with the scorers' draw caches cleared, before any live
call: a seeded torch draw (iforest's forest, loda's directions, cblof's and
gmm's centroids) is made before the trace and held as a constant, never
recorded as a random op nor cached from inside the trace, so the live call
after the export equals a fresh ensemble's live call to the bit. The knobs
are small (``BASE_KW``): each trained base retrains in every call.
"""

import functools

import numpy as np
import pytest

import vgan_tpu_torch.ensemble.od as TOD
import vgan_tpu_torch.serving as TS
from vgan_tpu_torch.ensemble import SubspaceEnsemble
from test_torch_bases import one_torch_thread  # noqa: F401  (module fixture)

RTOL, ATOL = 1e-5, 1e-6
BASES = sorted((*TOD._BASE_SCORERS, *TOD._DIM_BASES, *TOD._PARAM_BASES))
BASE_KW = dict(
    knn=dict(k=4), knn_mean=dict(k=4), lof=dict(k=5), abod=dict(k=5), cof=dict(k=5),
    sod=dict(k=5), iforest=dict(n_trees=12), inne=dict(n_trees=12),
    gmm=dict(n_clusters=3, kmeans_iter=6),
    cblof=dict(n_clusters=4, cluster_init="kmeans++", kmeans_iter=6),
    kpca=dict(kpca_n_components=4),
    ocsvm=dict(ocsvm_iters=40), ae=dict(ae_epochs=4, ae_hidden=(8, 4)),
    dsvdd=dict(ae_epochs=4, ae_hidden=(8, 4)), mcd=dict(mcd_steps=4, mcd_starts=3),
    loda=dict(n_projections=16), sos=dict(sos_iters=20), lmdd=dict(lmdd_dis="aad"),
)
# the lru-cached draws and tables of the scorers
CACHES = [TOD.draw_loda_directions, TOD.draw_centroids, TOD._inne_centres, TOD._mcd_tables,
          TOD._mcd_start_ranks, TOD._subsample_rows, TOD._fista_momenta, TOD._glorot_weights]


def test_every_native_base_is_listed():
    assert len(BASES) == 25


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    d = 6
    masks = rng.random((7, d)) < 0.5
    masks[:, 0] |= ~masks.any(axis=1)
    masks[1] = True
    return dict(xtr=rng.normal(size=(40, d)).astype(np.float32), masks=masks,
                proba=rng.random(7).astype(np.float32) + 0.1,
                tests=[rng.normal(size=(nt, d)).astype(np.float32) for nt in (11, 3)])


def _clear_caches():
    for cached in CACHES:
        cached.cache_clear()


@pytest.mark.parametrize("base", BASES)
def test_export_every_native_base(data, tmp_path, base):
    make = functools.partial(SubspaceEnsemble, data["masks"], data["proba"], base=base,
                             chunk=8, device="cpu", **BASE_KW.get(base, {}))
    ens = make().fit(data["xtr"])
    _clear_caches()
    TS.export_ensemble_scorer(ens, tmp_path / "ens.pt2")
    TS.export_per_subspace_scorer(ens, tmp_path / "per.pt2")
    fn = TS.load_ensemble_scorer(tmp_path / "ens.pt2")
    per = TS.load_ensemble_scorer(tmp_path / "per.pt2")
    live = [ens.decision_function(x) for x in data["tests"]]
    _clear_caches()
    fresh = make().fit(data["xtr"])
    for x, want in zip(data["tests"], live):
        np.testing.assert_array_equal(want, fresh.decision_function(x))
        got = fn(x)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got, fn(x))
        got = per(x)
        assert got.shape == (len(data["masks"]), len(x))
        np.testing.assert_allclose(got, ens.per_subspace_scores(x), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got, per(x))
