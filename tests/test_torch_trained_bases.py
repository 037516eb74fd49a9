"""The port's bases with iteration loops (ocsvm, sos, ae, dsvdd) against
``vgan_tpu.ensemble.od``: each scorer in float64 on the same numpy inputs
at its default iteration counts (ocsvm's 300 FISTA steps of 60 bisection
steps, sos's 64 bisection steps, 50 Adam epochs for ae and dsvdd, at a
narrow ``hidden=(8, 4)``), the ensemble knobs' guards, and
``SubspaceEnsemble(device="cpu")`` against the JAX ensemble in float32.

Tolerances, float64 on both sides: 1e-8 relative plus that fraction of the
largest score (an all-zero mask scores rounding noise around 0 in ocsvm).
The loops repeat the same operations, so rounding stays at a few hundred
ulp; ae's and dsvdd's initial weights are ``np.random.default_rng(seed)``'s
in both packages. The float32 ensembles hold at 1e-5 with every default;
ocsvm's take one chunk (its 300 x 60 small steps cost the CPU about a second
a chunk).
"""

import numpy as np
import pytest
import torch

import vgan_tpu_torch.ensemble.od as TOD
from vgan_tpu_torch import SubspaceEnsemble
from test_torch_sample_bases import (check_predict_labels_and_test_chunk, close, ensemble_pair,
                                     held, knob_guard_follows_jax, make_data)
from test_torch_sample_bases import data, one_torch_thread  # noqa: F401  (fixtures)

RTOL = 1e-8
HIDDEN = (8, 4)


@pytest.mark.parametrize("cfg", [dict(), dict(gamma=0.4), dict(nu=0.15, gamma=0.0)])
def test_ocsvm_vs_jax(cfg):
    """The default 300 iterations, gamma 0 (1 / popcount) and set, and a
    small nu (a tight cap: many bounded support vectors)."""
    xte, xtr, masks = make_data(10)
    held("ocsvm", RTOL, xte, xtr, masks, **cfg)


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("perplexity", [4.5, 12.0])
def test_sos_vs_jax(perplexity, exclude_self):
    """Both ways: under ``exclude_self`` the first 15 queries are the first
    15 train rows (the transductive formula), the rest novel."""
    xte, xtr, masks = make_data(11, nt=20)
    xte[:15] = xtr[:15]
    got = held("sos", RTOL, xte, xtr, masks, perplexity=perplexity, exclude_self=exclude_self)
    assert torch.all((got >= 0.0) & (got <= 1.0))


def test_sos_unreachable_perplexity_follows_jax():
    """The JAX package's guard admits a perplexity in [n_train - 1,
    n_train), which a binding distribution over n_train - 1 points cannot
    reach: its bisection halves beta every step. The port keeps the guard
    and the output: at n_train - 0.5 both packages agree, and every beta
    ends at 2^-iters."""
    xte, xtr, masks = make_data(12)
    for exclude_self in (False, True):
        held("sos", RTOL, xte, xtr, masks, perplexity=len(xtr) - 0.5, exclude_self=exclude_self)
    with pytest.raises(ValueError, match="perplexity < n_train"):
        TOD.sos_scores_masked(torch.from_numpy(xte), torch.from_numpy(xtr),
                              torch.from_numpy(masks), perplexity=float(len(xtr)))


@pytest.mark.parametrize("name,cfg", [("ae", {}), ("dsvdd", {}), ("ae", dict(lr=5e-3, seed=3)),
                                      ("dsvdd", dict(lr=5e-3, seed=3)),
                                      ("ae", dict(hidden=(5,)))])
def test_deep_bases_vs_jax(name, cfg):
    """50 full-batch Adam epochs from the same numpy Glorot draws; ae also
    with one hidden layer. (A one-layer dsvdd's initial centre is mean(z) W
    = 0 in exact arithmetic on standardized rows, so rounding noise picks
    its +-0.1 snap, in each package.)"""
    xte, xtr, masks = make_data(13)
    held(name, RTOL, xte, xtr, masks, **dict(dict(hidden=HIDDEN), **cfg))


@pytest.mark.parametrize("name", ["ae", "dsvdd"])
def test_deep_bases_train_under_no_grad(name):
    """A caller under ``torch.no_grad()`` still trains (the same scores) and
    gets a tensor without a graph."""
    xte, xtr, masks = make_data(14)
    args = (torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks))
    fn = getattr(TOD, f"{name}_scores_masked")
    want = fn(*args, hidden=HIDDEN, epochs=5)
    with torch.no_grad():
        got = fn(*args, hidden=HIDDEN, epochs=5)
    assert not got.requires_grad and got.grad_fn is None
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    untrained = fn(*args, hidden=HIDDEN, epochs=0)
    assert not torch.allclose(untrained[1], want[1])


def test_adam_step_is_the_jax_step():
    """Two steps of :func:`_adam_train` on ``sum(p^2 / 2)`` (gradient p),
    written out: eps on the raw sqrt(v), bias corrections in the step."""
    p0 = torch.tensor([[1.0, -2.0, 1e-9]], dtype=torch.float64)
    (p,) = TOD._adam_train(lambda ps: [ps[0]], [p0.clone()], 2, 0.1)
    want, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    for t in (1, 2):
        g = want.clone()
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + (1 - 0.999) * g * g
        want = want - 0.1 * np.sqrt(1 - 0.999**t) / (1 - 0.9**t) * m / (torch.sqrt(v) + 1e-8)
    np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("biases", [True, False])
def test_mlp_backward_is_autograd(biases, dtype):
    """:func:`_mlp_backward`, the gradients ae and dsvdd train on (live and
    in an exported program), equals ``torch.autograd.grad`` of the batched
    MLP to the bit, ReLU's zeros included."""
    rng = np.random.default_rng(15)
    widths, c, n = (6, 5, 3, 6), 4, 9
    params = []
    for a, b in zip(widths[:-1], widths[1:]):
        params.append(torch.tensor(rng.normal(size=(c, a, b)), dtype=dtype))
        if biases:
            params.append(torch.tensor(rng.normal(size=(c, 1, b)), dtype=dtype))
    z = torch.tensor(rng.normal(size=(c, n, widths[0])), dtype=dtype)
    g = torch.tensor(rng.normal(size=(c, n, widths[-1])), dtype=dtype)
    leaves = [p.clone().requires_grad_(True) for p in params]
    want = torch.autograd.grad(torch.sum(TOD._mlp(leaves, z, biases) * g), leaves)
    inputs = []
    TOD._mlp(params, z, biases, inputs)
    got = TOD._mlp_backward(params, inputs, g, biases)
    assert any(torch.any(i == 0) for i in inputs[1:])
    for w, h in zip(want, got):
        np.testing.assert_array_equal(h.numpy(), w.numpy())


def test_scorer_guards():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 3)))
    mask = torch.ones(3, dtype=torch.float64)
    cases = [
        (TOD.ocsvm_scores_masked, x[:1], {}, "at least 2 train rows"),
        (TOD.ocsvm_scores_masked, x, dict(nu=0.0), "nu must be in"),
        (TOD.ocsvm_scores_masked, x, dict(nu=1.5), "nu must be in"),
        (TOD.sos_scores_masked, x[:1], {}, "at least 2 train rows"),
        (TOD.sos_scores_masked, x, dict(perplexity=6.0), "perplexity < n_train"),
        (TOD.ae_scores_masked, x[:1], {}, "at least 2 train rows"),
        (TOD.dsvdd_scores_masked, x[:1], {}, "at least 2 train rows"),
    ]
    for fn, xtr, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(x, xtr, mask, 0, **kw)


@pytest.mark.parametrize("kw", [
    dict(ocsvm_nu=0.0), dict(ocsvm_nu=1.5), dict(ocsvm_nu=True), dict(ocsvm_gamma=-0.1),
    dict(ocsvm_iters=0), dict(ocsvm_iters=3.0), dict(sos_perplexity=0.0),
    dict(sos_perplexity=True), dict(sos_iters=0), dict(ae_hidden=()), dict(ae_hidden=(8, 0)),
    dict(ae_hidden=(8, True)), dict(ae_epochs=0), dict(ae_epochs=2.0), dict(ae_lr=0.0),
    dict(ae_lr=True),
])
def test_ensemble_knob_guards_follow_jax(kw):
    knob_guard_follows_jax(kw)


TRAINED_BASES = ["ocsvm", "sos", "ae", "dsvdd"]


@pytest.mark.parametrize("base", TRAINED_BASES)
def test_scores_do_not_depend_on_the_chunk(base):
    """The ensemble's float32 raw scores at chunk 1 and chunk 9 (an all-zero
    mask among them), every one finite; ae and dsvdd at a narrow width."""
    xte, xtr, masks = make_data(15, duplicates=False)
    raws = []
    for chunk in (1, 9):
        ens = SubspaceEnsemble(masks, np.ones(len(masks)), base=base, chunk=chunk, device="cpu",
                               ae_hidden=HIDDEN).fit(xtr.astype(np.float32))
        raws.append(ens._raw_per_subspace(xte.astype(np.float32), exclude_self=True))
    assert np.all(np.isfinite(raws[0]))
    np.testing.assert_allclose(raws[0], raws[1], rtol=1e-6, atol=1e-6 * np.abs(raws[0]).max())

# ocsvm, ae and dsvdd train anew in every scorer call, a second or so a
# chunk on the CPU (300 x 60 small steps; 50 Adam epochs): their ensembles
# take the pool as one chunk, and predict's 94-row batch comes in two slices.
ENS_KW = {base: dict(chunk=9, test_chunk=50) for base in ("ocsvm", "ae", "dsvdd")}


@pytest.mark.parametrize("aggregation", ["average", "max"])
@pytest.mark.parametrize("base", TRAINED_BASES)
def test_ensemble_decision_function_vs_jax(data, base, aggregation):
    kw = dict(dict(chunk=4), **ENS_KW.get(base, {}))
    jax_ens, port = ensemble_pair(data, base=base, k=5, aggregation=aggregation, **kw)
    got = port.decision_function(data["xte"])
    assert got.shape == (len(data["xte"]),) and np.all(np.isfinite(got))
    close(got, jax_ens.decision_function(data["xte"]))


@pytest.mark.parametrize("base", TRAINED_BASES)
def test_ensemble_predict_labels_and_test_chunk_vs_jax(data, base):
    check_predict_labels_and_test_chunk(data, base, **ENS_KW.get(base, {}))


def test_dsvdd_margins():
    """dsvdd's ``margins`` leave the scores as they are: one (masks,) margin
    of the centre snap, >= 0, and huge where every coordinate is an exact 0
    (the all-zero mask's embeddings: 0.1 over no magnitude)."""
    xte, xtr, masks = make_data(16)
    args = (torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks))
    margins = []
    got = TOD.dsvdd_scores_masked(*args, hidden=HIDDEN, epochs=3, margins=margins)
    np.testing.assert_array_equal(
        got.numpy(), TOD.dsvdd_scores_masked(*args, hidden=HIDDEN, epochs=3).numpy())
    assert len(margins) == 1 and margins[0].shape == (len(masks),)
    assert bool(torch.all(margins[0] >= 0)) and float(margins[0][0]) > 1e20
