"""The port's no-kl training (``vgan_tpu_torch.train``) in lockstep with
``vgan_tpu.train.steps``: one initial state carried over from JAX, the same
injected epoch permutations and noise on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.train.adadelta import AdadeltaState as JAdadeltaState
from vgan_tpu.train.adadelta import adadelta as jax_adadelta
from vgan_tpu.train import steps as JS
from vgan_tpu_torch.interop import adadelta_state_from_jax, generator_state_dict_from_jax
from vgan_tpu_torch.train import adadelta as TA
from vgan_tpu_torch.train import steps as TS


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _start_both(n, d, bs, jimpl, timpl, dtype):
    """A JAX no-kl state and the port's state carried over from it."""
    jconfig = JS.TrainConfig(ndims=d, batch_size=bs, mmd_impl=jimpl)
    jstate = JS.init_no_kl_state(jconfig, jax.random.PRNGKey(3))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cast = lambda t: jax.tree.map(lambda a: a.astype(jdt), t)
    jstate = jstate._replace(
        params=cast(jstate.params),
        opt_state=JAdadeltaState(cast(jstate.opt_state.square_avg),
                                   cast(jstate.opt_state.acc_delta)),
        bw_value=jnp.zeros((), jdt),
    )
    tconfig = TS.TrainConfig(ndims=d, batch_size=bs, mmd_impl=timpl)
    tstate = TS.init_no_kl_state(tconfig, 0, "cpu", dtype=dtype)
    tstate.generator.load_state_dict(generator_state_dict_from_jax(_np_tree(jstate.params)))
    tstate.opt_state = adadelta_state_from_jax(
        _np_tree(jstate.opt_state.square_avg), _np_tree(jstate.opt_state.acc_delta))
    return jconfig, jstate, tconfig, tstate


def _run_lockstep(n, d, bs, epochs, jimpl, timpl, dtype, seed):
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    x = rng.normal(size=(n, d)).astype(npdt)
    jconfig, jstate, tconfig, tstate = _start_both(n, d, bs, jimpl, timpl, dtype)
    nb, latent = n // bs, tconfig.latent_size
    assert latent == jconfig.latent_size
    jl, tl = [], []
    for _ in range(epochs):
        perm = rng.permutation(n)
        noise = rng.normal(size=(nb, bs, latent)).astype(npdt)
        jstate, loss = JS._no_kl_epoch_body(
            jstate, jnp.asarray(x), jconfig, rng=(jnp.asarray(perm), jnp.asarray(noise)))
        jl.append(float(loss))
        tstate, loss = TS.no_kl_epoch(
            tstate, torch.from_numpy(x), tconfig, rng=(torch.from_numpy(perm), torch.from_numpy(noise)))
        tl.append(float(loss))
    return jstate, tstate, np.asarray(jl), np.asarray(tl)


def _assert_params(jstate, tstate, rtol, atol):
    jparams = generator_state_dict_from_jax(_np_tree(jstate.params))
    for name, p in tstate.generator.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_no_kl_lockstep_float64():
    """Three epochs, dense paths ('jnp' and 'torch'), float64."""
    jstate, tstate, jl, tl = _run_lockstep(40, 16, 10, 3, "jnp", "torch", torch.float64, 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    _assert_params(jstate, tstate, rtol=1e-8, atol=1e-12)
    assert bool(tstate.bw_is_set) and bool(jstate.bw_is_set)
    np.testing.assert_allclose(float(tstate.bw_value), float(jstate.bw_value), rtol=1e-12)


def test_no_kl_lockstep_kernel_paths_float32():
    """Three epochs at d=600 (the flash regime): Pallas in interpret mode
    against the port's kernel Function on its plain versions, float32."""
    jstate, tstate, jl, tl = _run_lockstep(24, 600, 12, 3, "pallas", "cuda", torch.float32, 1)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    _assert_params(jstate, tstate, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.04])
def test_adadelta_matches_jax(weight_decay):
    rng = np.random.default_rng(5)
    shapes = {"main.0.weight": (3, 4), "main.0.bias": (3,)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    jopt = jax_adadelta(0.007, weight_decay=weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    topt = TA.Adadelta(0.007, weight_decay=weight_decay)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init(tparams)
    for _ in range(6):
        grads = {k: rng.normal(size=s) for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        topt.step(tparams, [torch.tensor(grads[k]) for k in tparams], tstate)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-10)
        np.testing.assert_allclose(tstate.square_avg[k].numpy(),
                                   np.asarray(jstate.square_avg[k]), rtol=1e-10)
        np.testing.assert_allclose(tstate.acc_delta[k].numpy(),
                                   np.asarray(jstate.acc_delta[k]), rtol=1e-10)


def test_adadelta_matches_torch_optim():
    """The reference trains with torch.optim.Adadelta(lr, weight_decay)."""
    rng = np.random.default_rng(6)
    w = torch.tensor(rng.normal(size=(5, 3)))
    ref = w.clone().requires_grad_()
    opt = torch.optim.Adadelta([ref], lr=0.007, weight_decay=0.04)
    ours = {"w": w.clone()}
    topt = TA.Adadelta(0.007, weight_decay=0.04)
    state = topt.init(ours)
    for _ in range(5):
        g = torch.tensor(rng.normal(size=(5, 3)))
        ref.grad = g.clone()
        opt.step()
        topt.step(ours, [g], state)
    np.testing.assert_allclose(ours["w"].numpy(), ref.detach().numpy(), rtol=1e-10)


def test_fit_program_is_seeded_and_freezes_bandwidth():
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(30, 8)))
    config = TS.TrainConfig(ndims=8, batch_size=10, mmd_impl="torch")
    s1, l1 = TS.no_kl_fit_program(x, 11, config, 2)
    s2, l2 = TS.no_kl_fit_program(x, 11, config, 2)
    _, l3 = TS.no_kl_fit_program(x, 12, config, 2)
    assert l1.shape == (2,) and torch.equal(l1, l2) and not torch.equal(l1, l3)
    assert bool(s1.bw_is_set) and float(s1.bw_value) > 0
    # the weights are drawn on the CPU from the seed alone
    g1, g2 = (s.generator.state_dict() for s in (s1, s2))
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def test_drop_last_batching_guard():
    with pytest.raises(ValueError):
        TS._batches_from_perm(torch.zeros(5, 3), torch.arange(5), 6)
    b = TS._batches_from_perm(torch.arange(21.0).reshape(7, 3), torch.arange(7), 3)
    assert b.shape == (2, 3, 3)


def test_train_config_guards():
    """The bf16 options take None or 'bfloat16' (ported: test_torch_bf16.py)."""
    for name in ("gram_matmul_dtype", "model_matmul_dtype", "opt_state_dtype"):
        assert getattr(TS.TrainConfig(ndims=4, batch_size=2, **{name: "bfloat16"}), name)
        with pytest.raises(ValueError):
            TS.TrainConfig(ndims=4, batch_size=2, **{name: "float16"})
    with pytest.raises(ValueError):
        TS.TrainConfig(ndims=4, batch_size=2, mmd_impl="pallas")
    with pytest.raises(ValueError):
        TS.TrainConfig(ndims=4, batch_size=2, generator_grad="nope")
    assert TS.TrainConfig(ndims=160, batch_size=2).latent_size == 10
    assert TS.TrainConfig(ndims=160, batch_size=2, latent_override=3).latent_size == 3


@pytest.mark.parametrize("grad", ["st", "gumbel_st"])
def test_generator_grad_variants_train(grad):
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(20, 6)))
    config = TS.TrainConfig(ndims=6, batch_size=10, mmd_impl="torch", generator_grad=grad)
    state, losses = TS.no_kl_fit_program(x, 1, config, 2)
    assert torch.all(torch.isfinite(losses))
    if grad == "gumbel_st":
        with pytest.raises(ValueError):
            TS.no_kl_epoch(state, x, config,
                           rng=(torch.arange(20), torch.zeros(2, 10, config.latent_size)))
