"""The port's sampling, projection and neighbour bases that train nothing
(loda, inne, sampling, sod, lmdd) against ``vgan_tpu.ensemble.od``: each
scorer in float64 on the same numpy inputs, vmapped over the masks on the
JAX side as its ensemble runs it, batched over the chunk on the port's; the
ensemble knobs' guards; and ``SubspaceEnsemble(device="cpu")`` against the
JAX ensemble in float32.

Tolerances, float64 on both sides: sod and lmdd 1e-9 (the same operations,
a few ulp); loda, inne and sampling 1e-8 (a few products and a square root
or logarithm of their sums), each relative plus that fraction of the largest
score (an all-zero mask scores rounding noise around 0).

loda's directions come from JAX's PRNG, which the port cannot reproduce:
the tests rebuild ``jax.random.normal(PRNGKey(seed), (d, P), dtype)`` and
feed it to the port (``directions=``; fixture ``jax_loda_draws`` for the
ensembles). inne's centres and sampling's subsample are
``np.random.default_rng(seed)``'s in both packages. sod's neighbour lists on
tie-heavy integer rows are held with the JAX side's dense selection
replaced by a stable one (``stable_jax_selection``, as for lof, abod and
cof).
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ensemble.od as JOD
import vgan_tpu_torch.ensemble.od as TOD
from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble
from vgan_tpu_torch import SubspaceEnsemble
from test_torch_bases import one_torch_thread, stable_jax_selection  # noqa: F401  (fixtures)

RTOL_SAME = 1e-9
RTOL = 1e-8
# ensembles: float32 on both sides, z-scored and summed over masks
RTOL_ENS = 1e-5


def make_data(seed=0, ntr=40, nt=15, d=7, n_masks=9, integer=False, duplicates=True):
    """Rows (a few test rows scaled out, two duplicated from the train rows
    unless ``duplicates`` is False) and masks with an all-zero, an
    all-column and a one-column mask among them; small integers give heavy
    ties and exact distances."""
    rng = np.random.default_rng(seed)
    if integer:
        xtr = rng.integers(-2, 3, size=(ntr, d)).astype(np.float64)
        xte = rng.integers(-2, 3, size=(nt, d)).astype(np.float64)
    else:
        xtr, xte = rng.normal(size=(ntr, d)), rng.normal(size=(nt, d))
        xte[:3] *= 3.0
    if duplicates:
        xte[5], xte[6] = xtr[5], xtr[6]
    masks = rng.random((n_masks, d)) < 0.5
    masks[0] = False
    masks[1] = True
    masks[2] = False
    masks[2, 3] = True
    return xte, xtr, masks


def port_scores(name, xte, xtr, masks, k=0, **kw):
    fn = getattr(TOD, f"{name}_scores_masked")
    return fn(torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks), k, **kw)


def jax_scores(name, xte, xtr, masks, k=0, **kw):
    """The JAX scorer vmapped over the masks, as its ensemble runs it."""
    fn = functools.partial(getattr(JOD, f"{name}_scores_masked"), k=k, **kw)
    batched = jax.jit(jax.vmap(lambda m: fn(jnp.asarray(xte), jnp.asarray(xtr), m)))
    return np.asarray(batched(jnp.asarray(masks, jnp.asarray(xtr).dtype)))


def held(name, rtol, xte, xtr, masks, k=0, port_kw=None, **kw):
    """The port's (masks, nt) float64 scores against JAX's, and one mask's
    (nt,) call against its row of the batch; returns the port's scores."""
    got = port_scores(name, xte, xtr, masks, k, **dict(kw, **(port_kw or {})))
    assert got.shape == (len(masks), len(xte)) and got.dtype == torch.float64
    assert torch.all(torch.isfinite(got))
    want = jax_scores(name, xte, xtr, masks, k, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))
    one = port_scores(name, xte, xtr, masks[4], k, **dict(kw, **(port_kw or {})))
    assert one.shape == (len(xte),)
    np.testing.assert_allclose(one.numpy(), got[4].numpy(), rtol=1e-12, atol=1e-12)
    return got


def jax_loda_directions(d, n_projections, seed, dtype=jnp.float64):
    """The JAX package's loda draw, ``loda_scores_masked``' own call."""
    w = jax.random.normal(jax.random.PRNGKey(seed), (d, n_projections), dtype)
    return torch.from_numpy(np.array(w))


@pytest.mark.parametrize("cfg", [dict(), dict(n_projections=30, n_bins=7, seed=3)])
def test_loda_vs_jax(cfg):
    xte, xtr, masks = make_data(0)
    xte[7] = 40.0  # far outside every train range: density 0
    w = jax_loda_directions(xtr.shape[1], cfg.get("n_projections", 100), cfg.get("seed", 0))
    got = held("loda", RTOL, xte, xtr, masks, port_kw=dict(directions=w), **cfg)
    assert float(got[1, 7]) > float(got[1, 8:].max())


def test_loda_default_draws_are_seeded_and_shared():
    """Without ``directions`` the port draws from a CPU generator seeded
    with ``seed``: one draw for every call and mask, another for another
    seed, and the same bits in float32 as the float64 draw rounded."""
    xte, xtr, masks = make_data(1)
    te, tr, mk = torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks)
    w = TOD.draw_loda_directions(7, 50, 4)
    assert w.shape == (7, 50) and w.dtype == torch.float64
    assert TOD.draw_loda_directions(7, 50, 4) is w
    assert not torch.equal(TOD.draw_loda_directions(7, 50, 5), w)
    np.testing.assert_array_equal(TOD.draw_loda_directions(7, 50, 4, None, torch.float32),
                                  w.float())
    a = TOD.loda_scores_masked(te, tr, mk, n_projections=50, seed=4)
    b = TOD.loda_scores_masked(te, tr, mk, n_projections=50, directions=w)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    for i in (3, 7):
        np.testing.assert_array_equal(
            TOD.loda_scores_masked(te, tr, mk[i], n_projections=50, seed=4).numpy(), a[i].numpy())


@pytest.mark.parametrize("cfg,integer", [(dict(), False),
                                         (dict(n_estimators=20, psi=50, seed=2), False),
                                         (dict(n_estimators=30, psi=3, seed=5), True)])
def test_inne_vs_jax(cfg, integer):
    """psi clamps to n_train (the second case draws every row a member).
    Duplicated train rows drawn together give zero radii (the ratio guard),
    on small-integer rows, whose distances are exact: on Gaussian rows a
    zero radius is rounding noise and so is the test of a query on that
    centre, in both packages."""
    xte, xtr, masks = make_data(2, integer=integer)
    if integer:
        xtr[10:20] = xtr[:10]
    got = held("inne", RTOL, xte, xtr, masks, **cfg)
    assert torch.all((got >= -1e30) & (got <= 1.0))


@pytest.mark.parametrize("cfg,integer", [(dict(), False), (dict(subset_size=60), True),
                                         (dict(subset_size=5, seed=9), False)])
def test_sampling_vs_jax(cfg, integer):
    """The subsample clamps to n_train (60 > 40: every row, so the test rows
    duplicated from train rows score exactly 0 on small-integer rows, whose
    distances are exact). The Gaussian cases duplicate no row: a test row
    equal to a drawn row scores the square root of its zero distance's
    rounding noise, in both packages."""
    xte, xtr, masks = make_data(3, integer=integer, duplicates=integer)
    got = held("sampling", RTOL, xte, xtr, masks, **cfg)
    if integer:
        np.testing.assert_array_equal(got[:, 5:7].numpy(), 0.0)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_sod_vs_jax(stable_jax_selection, exclude_self, integer):
    xte, xtr, masks = make_data(4, integer=integer)
    xte[:8] = xtr[:8]
    held("sod", RTOL_SAME, xte, xtr, masks, k=6, exclude_self=exclude_self)


def test_sod_knobs_vs_jax():
    xte, xtr, masks = make_data(5)
    held("sod", RTOL_SAME, xte, xtr, masks, k=4, ref_set=7, alpha=1.3)
    held("sod", RTOL_SAME, xte, xtr, masks, k=3, ref_set=60)  # ref_set clamps to n_train


def test_sod_reference_sets_tie_to_the_lowest_index():
    """On integer rows the SNN counts tie everywhere: the reference rows are
    the top counts with ties to the lowest index, the (count desc, index
    asc) order, in the port's selection as in the JAX package's key."""
    xte, xtr, masks = make_data(6, integer=True)
    m = torch.from_numpy(masks[1]).double()
    te, tr = torch.from_numpy(xte), torch.from_numpy(xtr)
    _, idx_tr = TOD._k_smallest_by_index(TOD._mask_diagonal(TOD._masked_sq_dists(tr, tr, m)), 5)
    _, idx_te = TOD._k_smallest_by_index(TOD._masked_sq_dists(te, tr, m), 5)
    t_ind = torch.zeros(40, 40, dtype=torch.float64).scatter_(-1, idx_tr, 1.0)
    snn = torch.zeros(15, 40, dtype=torch.float64).scatter_(-1, idx_te, 1.0) @ t_ind.T
    key = snn - torch.arange(40, dtype=torch.float64) * (0.5 / 40)
    got = torch.topk(key, 10, dim=-1).indices.numpy()
    order = np.lexsort((np.arange(40)[None].repeat(15, 0), -snn.numpy()), axis=1)
    np.testing.assert_array_equal(got, order[:, :10])
    assert len(np.unique(snn.numpy())) < 8  # the counts are heavily tied


@pytest.mark.parametrize("block", [256, 16])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("measure", ["var", "aad"])
def test_lmdd_vs_jax(monkeypatch, measure, exclude_self, block):
    """Both measures both ways; 'aad' also over 16-row train blocks (the
    block read at trace time on both sides: 40 rows in three blocks, the
    last one padded in JAX)."""
    for mod in (JOD, TOD):
        monkeypatch.setattr(mod, "_LMDD_BLOCK", block)
    xte, xtr, masks = make_data(7)
    xte[:9] = xtr[:9]
    xtr[:, 2] += 50.0  # a large mean: the closed forms do not cancel
    held("lmdd", RTOL_SAME, xte, xtr, masks, dis_measure=measure, exclude_self=exclude_self)


def test_scorer_guards():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 3)))
    mask = torch.ones(3, dtype=torch.float64)
    cases = [
        (TOD.inne_scores_masked, x[:1], 0, {}, "at least 2 train rows"),
        (TOD.inne_scores_masked, x, 0, dict(psi=1), "at least 2 train rows"),
        (TOD.sampling_scores_masked, x[:0], 0, {}, "at least 1 train row"),
        (TOD.sod_scores_masked, x, 0, {}, "1 <= k < n_train"),
        (TOD.sod_scores_masked, x, 6, {}, "1 <= k < n_train"),
        (TOD.sod_scores_masked, x, 2, dict(ref_set=0), "ref_set must be >= 1"),
        (TOD.lmdd_scores_masked, x, 0, dict(dis_measure="iqr"), "unknown dis_measure"),
        (TOD.lmdd_scores_masked, x[:1], 0, {}, "at least 2 train rows"),
    ]
    for fn, xtr, k, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(x, xtr, mask, k, **kw)
        with pytest.raises(ValueError, match=match):
            getattr(JOD, fn.__name__)(jnp.asarray(x.numpy()), jnp.asarray(xtr.numpy()),
                                      jnp.asarray(mask.numpy()), k, **kw)


def knob_guard_follows_jax(kw):
    """The port's constructor raises the JAX constructor's ``ValueError``."""
    masks, proba = np.ones((2, 3), bool), np.ones(2)
    kw = dict(dict(base="knn"), **kw)
    with pytest.raises(ValueError) as want:
        JaxEnsemble(masks, proba, **kw)
    with pytest.raises(ValueError) as got:
        SubspaceEnsemble(masks, proba, device="cpu", **kw)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("kw", [
    dict(inne_psi=1), dict(inne_psi=2.0), dict(inne_psi=True), dict(sod_ref_set=0),
    dict(sod_ref_set=1.5), dict(sod_alpha=0.0), dict(sod_alpha=True), dict(lmdd_dis="iqr"),
])
def test_ensemble_knob_guards_follow_jax(kw):
    knob_guard_follows_jax(kw)


def test_constructor_knobs_sit_where_jax_puts_them():
    """The port's constructor has the JAX constructor's parameters, in its
    order and with its defaults, and ``device`` last."""
    ours = list(inspect.signature(SubspaceEnsemble.__init__).parameters.values())
    theirs = list(inspect.signature(JaxEnsemble.__init__).parameters.values())
    assert [p.name for p in ours] == [p.name for p in theirs] + ["device"]
    for a, b in zip(ours, theirs):
        assert a.default == b.default, a.name
    ens = SubspaceEnsemble(np.ones((1, 3), bool), np.ones(1), base="inne", device="cpu",
                           n_projections=7, inne_psi=3, ae_hidden=[5, 2], lmdd_dis="aad")
    params = TOD._scorer_params(ens)
    assert (params["n_projections"], params["inne_psi"], params["ae_hidden"],
            params["lmdd_dis"]) == (7, 3, (5, 2), "aad")
    assert set(params) <= set(inspect.signature(TOD._scorer_and_k).parameters)


def test_effective_chunk_follows_the_jax_governor():
    """The nine bases' chunks: the JAX package's where the port holds what
    JAX does, at most that where eager torch holds more (sod's sorts, ae's
    and dsvdd's saved activations); loda and sampling take the eager rule,
    with no JAX branch."""
    knobs = dict(n_trees=100, inne_psi=8, ae_hidden=(64, 32), sod_ref_set=10)
    for base, nt, ntr, d, kw in (
            ("inne", 500, 1000, 100, {}), ("inne", 500, 2000, 10240, dict(n_trees=20)),
            ("ocsvm", 500, 1000, 100, {}), ("sos", 500, 1000, 100, {}),
            ("sos", 1500, 2000, 10240, {}), ("lmdd", 500, 1000, 100, {}),
            ("lmdd", 500, 2000, 10240, {}), ("sod", 500, 1000, 100, {}),
            ("sod", 1500, 1000, 100, dict(sod_ref_set=3)), ("ae", 500, 1000, 100, {}),
            ("dsvdd", 500, 1000, 100, dict(ae_hidden=(8,))), ("ae", 20, 40, 7, {})):
        cfg = dict(knobs, **kw)
        want = JOD._effective_chunk(base, 128, nt, ntr, d, k=10, **cfg)
        got = TOD._effective_chunk(base, 128, nt, ntr, d, 10, **cfg)
        assert 1 <= got <= want, (base, got, want)
        if base not in ("sod", "ae", "dsvdd"):
            assert got == want, (base, got, want)
    assert TOD._effective_chunk("sod", 128, 500, 1000, 100, 10) == 7
    assert TOD._effective_chunk("ae", 128, 500, 1000, 100) == 48
    for base in ("loda", "sampling"):
        assert JOD._effective_chunk(base, 128, 500, 2000, 10240) == 128
        # the masked query rows and the (nt, ntr) distances under 2^27
        assert TOD._effective_chunk(base, 128, 500, 2000, 10240) == 21


SAMPLE_BASES = ["loda", "inne", "sampling", "sod", "lmdd"]


@pytest.mark.parametrize("base", SAMPLE_BASES)
def test_scores_do_not_depend_on_the_chunk(base):
    """The ensemble's float32 raw scores at chunk 1 and chunk 9 (the whole
    pool, an all-zero mask in it), and every one finite. No test row
    duplicates a train row: its f32 distance to that row is rounding noise
    whose bits follow the product's batch shape (sampling takes its square
    root)."""
    xte, xtr, masks = make_data(8, duplicates=False)
    raws = []
    for chunk in (1, 9):
        ens = SubspaceEnsemble(masks, np.ones(len(masks)), base=base, k=5, chunk=chunk,
                               device="cpu").fit(xtr.astype(np.float32))
        raws.append(ens._raw_per_subspace(xte.astype(np.float32), exclude_self=True))
    assert np.all(np.isfinite(raws[0]))
    np.testing.assert_allclose(raws[0], raws[1], rtol=1e-6, atol=1e-6 * np.abs(raws[0]).max())


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
def jax_loda_draws(monkeypatch):
    """The port's loda directions replaced by the JAX package's float32
    draw (the JAX ensemble scores float32 rows)."""
    def draws(d, n_projections, seed, device=None, dtype=torch.float64):
        w = jax_loda_directions(d, n_projections, seed, jnp.float32)
        return w.to(device=device, dtype=dtype)

    monkeypatch.setattr(TOD, "draw_loda_directions", draws)


def close(got, want, rtol=RTOL_ENS):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


def ensemble_pair(data, **kw):
    jax_ens = JaxEnsemble(data["masks"], data["proba"], **kw).fit(data["xtr"])
    port = SubspaceEnsemble(data["masks"], data["proba"], device="cpu", **kw).fit(data["xtr"])
    return jax_ens, port


def labels_agree(got, want, scores, threshold):
    """Labels equal except for rows within the tolerance of the threshold."""
    near = np.abs(scores - threshold) <= RTOL_ENS * (abs(threshold) + np.abs(scores).max())
    np.testing.assert_array_equal(np.asarray(got)[~near], np.asarray(want)[~near])


@pytest.mark.parametrize("aggregation", ["average", "max"])
@pytest.mark.parametrize("base", SAMPLE_BASES)
def test_ensemble_decision_function_vs_jax(data, jax_loda_draws, base, aggregation):
    jax_ens, port = ensemble_pair(data, base=base, k=5, aggregation=aggregation, chunk=4)
    got = port.decision_function(data["xte"])
    assert got.shape == (len(data["xte"]),) and np.all(np.isfinite(got))
    close(got, jax_ens.decision_function(data["xte"]))


def check_predict_labels_and_test_chunk(data, base, drawn_rows=(), test_chunk=7, chunk=4, **kw):
    """predict, threshold_, decision_scores_, labels_ and a test-chunked
    decision_function of one base against the JAX ensemble. ``drawn_rows``
    are train rows whose training score is rounding noise in both packages
    (sampling: a drawn row's distance to itself); each package's score there
    is held to its f32 bound instead. Returns the pair."""
    jax_ens, port = ensemble_pair(data, base=base, k=5, chunk=chunk, test_chunk=test_chunk, **kw)
    labels = port.predict(data["xte"])
    want_labels = jax_ens.predict(data["xte"])
    assert np.isclose(port.threshold_, jax_ens.threshold_, rtol=RTOL_ENS,
                      atol=RTOL_ENS * np.abs(port.decision_scores_).max())
    both = port.decision_function(np.concatenate([data["xtr"], data["xte"]]), exclude_self=True)
    labels_agree(labels, want_labels, both[len(data["xtr"]):], port.threshold_)
    keep = np.ones(len(data["xtr"]), bool)
    keep[list(drawn_rows)] = False
    close(port.decision_scores_[keep], np.asarray(jax_ens.decision_scores_)[keep])
    assert np.all(np.isfinite(port.decision_scores_))
    port_labels = port.labels_
    np.testing.assert_array_equal(port_labels, port.decision_scores_ > port.threshold_)
    labels_agree(port_labels, jax_ens.labels_, port.decision_scores_, port.threshold_)
    if test_chunk is None:
        jax_ens, port = ensemble_pair(data, base=base, k=5, chunk=chunk, test_chunk=7, **kw)
    close(port.decision_function(data["xte"]), jax_ens.decision_function(data["xte"]))
    return jax_ens, port


@pytest.mark.parametrize("base", ["loda", "inne", "sod", "lmdd"])
def test_ensemble_predict_labels_and_test_chunk_vs_jax(data, jax_loda_draws, base):
    """loda's predict scores the train rows in one batch: the JAX package
    decides its range tests in f32 on projections whose bits follow the
    batch's row count, so with predict's batch in 7-row slices a train row
    that sets a direction's minimum or maximum falls outside the range there
    (71 entries on this data; the port's are within 1.5e-6 of float64). Its
    test-chunked decision_function is held on the test rows."""
    jax_ens, port = check_predict_labels_and_test_chunk(
        data, base, test_chunk=None if base == "loda" else 7)
    close(port.per_subspace_scores(data["xte"]), jax_ens.per_subspace_scores(data["xte"]))


def test_sampling_ensemble_predict_labels_and_test_chunk_vs_jax(data):
    """sampling with raw scores: a train row in the subsample scores the
    square root of its own f32 distance, the cancellation of |x|^2 + |x|^2
    - 2 x.x (within (s + 2) 2^-24 4 |x|^2 over s selected columns), in both
    packages; a z-score would spread that noise over every row. The drawn
    rows are held to that bound, every other row at 1e-5."""
    drawn = TOD._subsample_rows(len(data["xtr"]), 20, 0)
    jax_ens, port = check_predict_labels_and_test_chunk(data, "sampling", drawn_rows=drawn,
                                                        normalize=None)
    m = data["masks"].astype(np.float64)
    sq = (data["xtr"][drawn].astype(np.float64) ** 2) @ m.T  # (rows, masks)
    bound = np.sqrt((m.sum(axis=1) + 2.0) * 2.0**-24 * 4.0 * sq) @ port.proba
    for scores in (port.decision_scores_, np.asarray(jax_ens.decision_scores_)):
        assert np.all(scores[drawn] <= bound + 1e-6)


def test_decision_margins():
    """``margins`` leaves the scores as they are and receives, per decision
    stage, (masks,) or (masks, nt) margins, each >= 0; on small-integer rows
    (exact distances, ties everywhere) sod's neighbour places and inne's
    coverage tests tie exactly somewhere, a margin of 0."""
    for integer in (False, True):
        xte, xtr, masks = make_data(9, integer=integer, duplicates=False)
        te, tr, mk = torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks)
        for name, k, shapes in (("loda", 0, [(9, 15)]), ("inne", 0, [(9,), (9, 15)]),
                                ("sod", 5, [(9, 15)])):
            fn = getattr(TOD, f"{name}_scores_masked")
            margins = []
            got = fn(te, tr, mk, k, margins=margins)
            np.testing.assert_array_equal(got.numpy(), fn(te, tr, mk, k).numpy())
            assert [tuple(m.shape) for m in margins] == shapes
            assert all(bool(torch.all(m >= 0)) for m in margins)
            least = float(torch.stack([m.amin() for m in margins]).amin())
            if name != "loda":
                assert (least == 0.0) == integer
