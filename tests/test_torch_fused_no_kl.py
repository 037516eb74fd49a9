"""The port's fused whole-fit path (``vgan_tpu_torch.ops.cuda.fused_no_kl``)
against ``vgan_tpu.ops.pallas.fused_no_kl`` in interpret mode, and against
the port's own autograd training step in float64; plus the estimator's
``fit_impl='fused'`` on the CPU.

Both implementations get the same initial params (through ``interop``), the
same noise (T, BSP, LP), offsets and JAX's returned permutation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.ops.pallas import fused_no_kl as JF
from vgan_tpu.train import steps as JS
from vgan_tpu_torch import VGAN_no_kl
from vgan_tpu_torch.interop import generator_state_dict_from_jax
from vgan_tpu_torch.ops import mmd as TM
from vgan_tpu_torch.ops.cuda import fused_no_kl as TF
from vgan_tpu_torch.train import steps as TS
from vgan_tpu_torch.train.adadelta import Adadelta

# (n, d, bs, epochs): JAX's own parity shape, and a batch size that is not a
# multiple of 64 (the row mask) with n // bs = 2
JAX_CASES = {"main": (256, 24, 64, 3), "ragged": (200, 12, 100, 2)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(n, d, bs, epochs, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 0] *= 3.0
    nb, bsp = n // bs, TF.round_up(bs, 64)
    noise = rng.normal(size=(epochs * nb, bsp, TF.LP)).astype(np.float32)
    offsets = rng.integers(0, n, size=(epochs,)).astype(np.int32)
    return x, noise, offsets


def _port_generator(params_np, d, bs, dtype=torch.float32):
    config = TS.TrainConfig(ndims=d, batch_size=bs, lr_g=0.01)
    gen = config.generator_module(kl=False, train=True, dtype=dtype)
    sd = generator_state_dict_from_jax(params_np)
    gen.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
    opt = Adadelta(config.lr_g, weight_decay=config.weight_decay).init(dict(gen.named_parameters()))
    return config, gen, opt


@pytest.fixture(scope="module", params=sorted(JAX_CASES))
def jax_and_port(request):
    """One JAX interpret-mode fit and the port's plain version on the same
    inputs (two JAX calls per module, one per case)."""
    n, d, bs, epochs = JAX_CASES[request.param]
    x, noise, offsets = _inputs(n, d, bs, epochs, seed=1)
    jconfig = JS.TrainConfig(ndims=d, batch_size=bs, lr_g=0.01)
    jstate = JS.init_no_kl_state(jconfig, jax.random.PRNGKey(1))
    params_np = _np_tree(jstate.params)
    jout = JF.fused_no_kl_fit(x, jstate.params, jconfig, epochs, jax.random.PRNGKey(5),
                              noise=jnp.asarray(noise), offsets=offsets)
    config, gen, opt = _port_generator(params_np, d, bs)
    tout = TF.fused_no_kl_fit(torch.from_numpy(x), gen, opt, config, epochs, seed=0,
                              noise=torch.from_numpy(noise), offsets=offsets, perm=jout[4])
    return jout, tout


def test_plain_version_matches_jax_kernel(jax_and_port):
    """Tolerances of JAX's own kernel-vs-oracle test."""
    (jp, (jsq, jacc), (jbw, jset), jl, jperm, joffs), (tp, (tsq, tacc), (tbw, tset), tl, tperm,
                                                        toffs) = jax_and_port
    assert bool(jset) and bool(tset)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(toffs, joffs)
    np.testing.assert_allclose(float(tbw), float(jbw), rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-5, atol=1e-6)
    for got, want in ((tp, jp), (tsq, jsq), (tacc, jacc)):
        want = generator_state_dict_from_jax(_np_tree(want))
        for name, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=name)


def _autograd_trajectory(x, gen, config, epochs, perm, offsets, noise):
    """The same rotational schedule through the port's generator,
    ``mmd_loss_constrained_stateful`` (dense torch path) and ``Adadelta``."""
    n = x.shape[0]
    bs, latent = config.batch_size, config.latent_size
    nb = n // bs
    params = dict(gen.named_parameters())
    opt = Adadelta(config.lr_g, weight_decay=config.weight_decay)
    state = opt.init(params)
    x_perm = x[torch.from_numpy(np.asarray(perm))]
    bw_value = torch.zeros((), dtype=x.dtype)
    bw_is_set = torch.zeros((), dtype=torch.bool)
    losses, t = [], 0
    for e in range(epochs):
        for i in range(nb):
            start = (int(offsets[e]) + i * bs) % n
            batch = x_perm[torch.from_numpy((start + np.arange(bs)) % n)]
            z = noise[t, :bs, :latent]
            u = gen(z)
            loss, bw = TM.mmd_loss_constrained_stateful(
                batch, u * batch, u, weight=config.penalty_weight, bw_value=bw_value,
                bw_is_set=bw_is_set, impl="torch")
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.step(params, grads, state)
            bw_value, bw_is_set = bw.detach(), torch.ones((), dtype=torch.bool)
            losses.append(float(loss.detach()))
            t += 1
    return np.asarray(losses).reshape(epochs, nb), float(bw_value), state


@pytest.mark.parametrize("n,d,bs,epochs", [(256, 24, 64, 3), (50, 16, 50, 2), (200, 12, 100, 2)])
def test_plain_version_matches_autograd_float64(n, d, bs, epochs):
    """The hand-written backward against autograd on the port's own
    training step, in float64, at the slice-1 lockstep bounds; (50, bs=50)
    reads the wraparound tail (n < BSP), bs=100 the row mask."""
    x, noise, offsets = _inputs(n, d, bs, epochs, seed=2)
    x64, noise64 = torch.from_numpy(x).double(), torch.from_numpy(noise).double()
    perm = np.random.default_rng(3).permutation(n)
    jstate = JS.init_no_kl_state(JS.TrainConfig(ndims=d, batch_size=bs), jax.random.PRNGKey(2))
    params_np = _np_tree(jstate.params)
    config, gen, opt = _port_generator(params_np, d, bs, torch.float64)
    params, (sq, acc), (bw, bw_set), losses, _, _ = TF.fused_no_kl_fit(
        x64, gen, opt, config, epochs, seed=0, noise=noise64, offsets=offsets, perm=perm)
    assert losses.dtype == torch.float64 and bool(bw_set)
    _, ref_gen, _ = _port_generator(params_np, d, bs, torch.float64)
    ref_losses, ref_bw, ref_state = _autograd_trajectory(x64, ref_gen, config, epochs, perm,
                                                         offsets, noise64)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=1e-9)
    np.testing.assert_allclose(float(bw), ref_bw, rtol=1e-12)
    for name, p in ref_gen.named_parameters():
        for got, want in ((params[name], p), (sq[name], ref_state.square_avg[name]),
                          (acc[name], ref_state.acc_delta[name])):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-8,
                                       atol=1e-12, err_msg=name)


@pytest.mark.parametrize("n,d,bs,latent", [
    (2000, 10, 500, 1), (2000, 200, 500, 12), (2000, 10, 1500, 1), (60000, 10, 500, 1),
    (2000, 128, 1000, 8), (2000, 128, 1025, 8), (15360, 10, 1000, 1), (15361, 10, 1000, 1),
    (100, 16, 1, 1), (100, 16, 2, 1), (2000, 128, 500, 16), (2000, 128, 500, 17),
])
def test_fused_supported_matches_jax(n, d, bs, latent):
    assert TF.fused_supported(n, d, bs, latent) == JF.fused_supported(n, d, bs, latent)


def test_ladder_matches_jax():
    mults = TM.bandwidth_multipliers()
    base, lad = TF.ladder(mults)
    jbase, jints = JF._ladder(mults)
    assert base == jbase and lad == tuple(sorted(zip(jints, mults)))


@pytest.mark.parametrize("mults", [(3.0, 1.0), (0.3, 1.0, 2.7)])
def test_ladder_rejects_what_jax_asserts(mults):
    """Exponents (1, 3) are integer but not powers of two; (0.3, 1, 2.7) is
    not integer-structured."""
    with pytest.raises(ValueError):
        TF.ladder(mults)
    with pytest.raises(AssertionError):
        JF._ladder(mults)


def test_pack_unpack_round_trip_and_jax_layout():
    d, bs = 40, 64
    jconfig = JS.TrainConfig(ndims=d, batch_size=bs)
    params = _np_tree(JS.init_no_kl_state(jconfig, jax.random.PRNGKey(4)).params)
    latent = jconfig.latent_size
    _, gen, _ = _port_generator(params, d, bs)
    sd = dict(gen.state_dict())
    w, b = TF.pack_params(sd, latent, d)
    jw, jb = JF._pack_params(params, latent, d)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    back = TF.unpack_params(w, b, latent, d)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("n,d,bs", [(50, 16, 50), (200, 12, 100), (256, 24, 64)])
def test_schedule_matches_jax_layout(n, d, bs):
    """x3 is JAX's: the permuted rows, then a tail that cycles them as
    ``np.resize`` does (n < BSP included), zero-padded to DP lanes."""
    x, _, offsets = _inputs(n, d, bs, 2, seed=8)
    perm = np.random.default_rng(9).permutation(n)
    x3, starts, perm_out, offs = TF.schedule(torch.from_numpy(x), bs, 2, perm, offsets, None, None)
    bsp = TF.round_up(bs, 64)
    want = np.zeros((n + bsp, TF.DP), np.float32)
    want[:n, :d] = x[perm]
    want[n:, :d] = np.resize(x[perm], (bsp, d))
    np.testing.assert_array_equal(x3.numpy(), want)
    np.testing.assert_array_equal(perm_out, perm)
    np.testing.assert_array_equal(offs, offsets)
    nb = n // bs
    assert starts.tolist() == [(int(offsets[e]) + i * bs) % n for e in range(2) for i in range(nb)]


def test_phase_timer_refused_on_a_cpu_tensor():
    """K8's phase timer is read on the card: ``phase_ns`` on the CPU is
    refused before anything is built or launched, as is the kernel itself
    on CPU tensors."""
    n, d, bs, epochs = 128, 16, 64, 1
    x, _, offsets = _inputs(n, d, bs, epochs, seed=10)
    x3, starts, _, _ = TF.schedule(torch.from_numpy(x), bs, epochs, np.arange(n), offsets, None,
                                   None)
    config = TS.TrainConfig(ndims=d, batch_size=bs)
    state = TS.init_no_kl_state(config, 0, "cpu")
    packed = [*TF.pack_params(dict(state.generator.state_dict()), config.latent_size, d),
              *TF.pack_params(state.opt_state.square_avg, config.latent_size, d),
              *TF.pack_params(state.opt_state.acc_delta, config.latent_size, d)]
    kw = dict(n=n, d=d, bs=bs, latent=config.latent_size, lr=config.lr_g,
              weight_decay=config.weight_decay, penalty_weight=config.penalty_weight)
    starts_t = torch.from_numpy(starts.astype(np.int32))
    TF.reset_launch_counts()
    with pytest.raises(ValueError, match="phase_ns"):
        TF.fused_no_kl_fit_cuda(x3, starts_t, *packed, None, 0,
                                phase_ns=torch.zeros(len(TF.PHASES), dtype=torch.int64), **kw)
    with pytest.raises(ValueError, match="on the card"):
        TF.fused_no_kl_fit_cuda(x3, starts_t, *packed, None, 0, **kw)
    assert TF.launch_counts() == {"fused_no_kl_fit_cuda": 0}


def test_zero_epochs_is_a_no_op():
    n, d, bs = 128, 16, 64
    config = TS.TrainConfig(ndims=d, batch_size=bs)
    state = TS.init_no_kl_state(config, 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(n, d)).astype(np.float32))
    TF.reset_launch_counts()
    params, (sq, acc), (bw, bw_set), losses, perm, offsets = TF.fused_no_kl_fit(
        x, state.generator, state.opt_state, config, 0, seed=1)
    assert TF.launch_counts() == {"fused_no_kl_fit_cuda": 0}
    for k, v in state.generator.state_dict().items():
        assert torch.equal(params[k], v), k
        assert not sq[k].any() and not acc[k].any()
    assert tuple(losses.shape) == (0, n // bs) and not bool(bw_set) and float(bw) == 0.0
    assert sorted(perm.tolist()) == list(range(n)) and offsets.shape == (0,)


def test_fit_is_seeded():
    n, d, bs = 96, 16, 32
    config = TS.TrainConfig(ndims=d, batch_size=bs)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(n, d)).astype(np.float32))
    runs = []
    for seed in (3, 3, 4):
        state = TS.init_no_kl_state(config, 0, "cpu")
        runs.append(TF.fused_no_kl_fit(x, state.generator, state.opt_state, config, 2, seed))
    assert torch.equal(runs[0][3], runs[1][3]) and not torch.equal(runs[0][3], runs[2][3])
    np.testing.assert_array_equal(runs[0][4], runs[1][4])


def _data(n=128, d=16, seed=7):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_estimator_fused_fit_and_sampling():
    m = VGAN_no_kl(batch_size=64, epochs=3, lr=0.01, verbose=False, fit_impl="fused",
                   device="cpu")
    m.fit(_data())
    h = m.train_history["generator_loss"]
    assert len(h) == 3 and all(np.isfinite(h))
    assert m.bandwidth is not None and m.bandwidth > 0
    assert m.bandwidth == float(m.train_state.bw_value) and bool(m.train_state.bw_is_set)
    u = m.generate_subspaces(32)
    assert u.shape == (32, 16) and u.dtype == np.bool_


def test_estimator_fused_then_continue_fit_keeps_bandwidth():
    x = _data()
    m = VGAN_no_kl(batch_size=64, epochs=2, lr=0.01, verbose=False, fit_impl="fused",
                   device="cpu")
    m.fit(x)
    bw = m.bandwidth
    # the Adadelta state came out of the fused fit, not the zeros it started from
    assert any(v.any() for v in m.train_state.opt_state.square_avg.values())
    m.continue_fit(x, epochs=2)
    h = m.train_history["generator_loss"]
    assert len(h) == 4 and np.isfinite(h[-1])
    assert m.bandwidth == bw


def test_estimator_fused_small_dataset():
    m = VGAN_no_kl(batch_size=50, epochs=2, lr=0.01, verbose=False, fit_impl="fused",
                   device="cpu")
    m.fit(_data(n=50))
    assert np.isfinite(m.train_history["generator_loss"][-1])


@pytest.mark.parametrize("kwargs,d", [
    (dict(generator_grad="st"), 16), (dict(checkpoint_every=1), 16), ({}, 200),
])
def test_estimator_fused_guards(kwargs, d, tmp_path):
    m = VGAN_no_kl(batch_size=64, epochs=1, verbose=False, fit_impl="fused", device="cpu",
                   **kwargs)
    with pytest.raises(ValueError):
        m.fit(_data(d=d))
