"""The port's kl variant (``models/detector.py``, the ``active`` flags of
Adadelta, ``AlternationSchedule`` and the kl epochs of ``train/steps.py``)
in lockstep with ``vgan_tpu``: one initial state carried over from JAX, the
same injected epoch permutations and noise on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.models.detector import Detector as JDetector
from vgan_tpu.train import steps as JS
from vgan_tpu.train.adadelta import AdadeltaState as JAdadeltaState
from vgan_tpu.train.adadelta import adadelta as jax_adadelta
from vgan_tpu_torch.interop import (
    adadelta_state_from_jax,
    detector_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from vgan_tpu_torch.models.detector import Detector
from vgan_tpu_torch.train import adadelta as TA
from vgan_tpu_torch.train import steps as TS

D, G = TS.PHASE_DETECTOR, TS.PHASE_GENERATOR


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_detector_forward_and_layout_match_flax():
    d, latent, n = 40, 3, 7
    jdet = JDetector(latent_size=latent, in_features=d, param_dtype=jnp.float64)
    params = jdet.init(jax.random.PRNGKey(1), jnp.zeros((1, d), jnp.float64))
    x = np.random.default_rng(2).normal(size=(n, d))
    enc_j, dec_j = jdet.apply(params, jnp.asarray(x))
    tdet = Detector(latent, d, dtype=torch.float64)
    tdet.load_state_dict(detector_state_dict_from_jax(_np_tree(params)))
    enc_t, dec_t = tdet(torch.from_numpy(x))
    np.testing.assert_allclose(enc_t.detach().numpy(), np.asarray(enc_j), rtol=1e-12)
    np.testing.assert_allclose(dec_t.detach().numpy(), np.asarray(dec_j), rtol=1e-12)

    # the reference's Detector state-dict layout, torch (out, in) weights
    widths = {"encoder": [d, 8 * latent, 4 * latent, 2 * latent, latent],
              "decoder": [latent, 2 * latent, 4 * latent, 8 * latent, d]}
    sd = Detector(latent, d, generator=torch.Generator().manual_seed(0)).state_dict()
    assert list(sd) == [f"{part}.main.{i}.{p}" for part in ("encoder", "decoder")
                        for i in range(4) for p in ("weight", "bias")]
    for part, w in widths.items():
        for i in range(4):
            assert sd[f"{part}.main.{i}.weight"].shape == (w[i + 1], w[i])
            assert not sd[f"{part}.main.{i}.bias"].any(), "kl init: zero biases"
    assert abs(float(sd["encoder.main.0.weight"].std()) - 0.1) < 0.01, "kl init: N(0, 0.1)"


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("flag", [True, False, "device True", "device False"])
def test_adadelta_active_flags_match_jax(flag, state_dtype):
    """A frozen leaf takes no update, no weight decay and no state advance;
    the flag may be a host bool or a 0-dim device tensor. Float64
    parameters; a full-precision state within 1e-10 of JAX's, a bf16 state
    equal to it to the bit."""
    rng = np.random.default_rng(5)
    shapes = {"encoder.main.0.weight": (3, 4), "decoder.main.0.bias": (3,)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    on = flag if isinstance(flag, bool) else flag == "device True"
    jopt = jax_adadelta(0.007, weight_decay=0.04, state_dtype=state_dtype)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    jactive = {"encoder.main.0.weight": jnp.asarray(on), "decoder.main.0.bias": True}
    topt = TA.Adadelta(0.007, weight_decay=0.04, state_dtype=state_dtype)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init(tparams)
    tactive = {"encoder.main.0.weight": flag if isinstance(flag, bool) else torch.tensor(on)}
    for _ in range(4):
        grads = {k: rng.normal(size=s) for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                  jparams, active=jactive)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        topt.step(tparams, [torch.tensor(grads[k]) for k in tparams], tstate, active=tactive)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-10)
        for mine, theirs in ((tstate.square_avg[k], jstate.square_avg[k]),
                             (tstate.acc_delta[k], jstate.acc_delta[k])):
            if state_dtype is None:
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-10)
            else:
                assert mine.dtype == torch.bfloat16
                np.testing.assert_array_equal(mine.float().numpy(),
                                              np.asarray(theirs).astype(np.float32))
    name = "encoder.main.0.weight"
    assert np.array_equal(tparams[name].numpy(), params[name]) == (not on)
    assert bool(torch.all(tstate.square_avg[name] == 0)) == (not on)


@pytest.mark.parametrize("iternum_d,iternum_g", [(1, 5), (2, 3), (1, 1), (3, 0), (0, 2)])
def test_alternation_schedule_matches_jax(iternum_d, iternum_g):
    js = JS.AlternationSchedule(iternum_d, iternum_g)
    ts = TS.AlternationSchedule(iternum_d, iternum_g)
    for epochs in (7, 11):  # the counters carry over between calls
        np.testing.assert_array_equal(ts.phase_array(epochs), js.phase_array(epochs))


def _start_kl_both(d, bs, jimpl, timpl, dtype, flags):
    """A JAX kl state and the port's state carried over from it."""
    # scan_unroll=1: the unrolled scan only multiplies the compile time here
    jconfig = JS.TrainConfig(ndims=d, batch_size=bs, mmd_impl=jimpl, scan_unroll=1, **flags)
    jstate = JS.init_kl_state(jconfig, jax.random.PRNGKey(3))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cast = lambda t: jax.tree.map(lambda a: a.astype(jdt), t)
    jstate = jstate._replace(
        gen_params=cast(jstate.gen_params),
        det_params=cast(jstate.det_params),
        gen_opt=JAdadeltaState(cast(jstate.gen_opt.square_avg), cast(jstate.gen_opt.acc_delta)),
        det_opt=JAdadeltaState(cast(jstate.det_opt.square_avg), cast(jstate.det_opt.acc_delta)),
        bw_value=jnp.zeros((), jdt),
    )
    tconfig = TS.TrainConfig(ndims=d, batch_size=bs, mmd_impl=timpl, **flags)
    tstate = TS.init_kl_state(tconfig, 0, "cpu", dtype=dtype)
    tstate.generator.load_state_dict(generator_state_dict_from_jax(_np_tree(jstate.gen_params)))
    tstate.detector.load_state_dict(detector_state_dict_from_jax(_np_tree(jstate.det_params)))
    tstate.gen_opt = adadelta_state_from_jax(_np_tree(jstate.gen_opt.square_avg),
                                             _np_tree(jstate.gen_opt.acc_delta))
    tstate.det_opt = adadelta_state_from_jax(_np_tree(jstate.det_opt.square_avg),
                                             _np_tree(jstate.det_opt.acc_delta))
    assert bool(tstate.encoder_active) == bool(jstate.encoder_active)
    return jconfig, jstate, tconfig, tstate


def _kl_lockstep(phases, n, d, bs, jimpl, timpl, dtype, flags, seed):
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    x = rng.normal(size=(n, d)).astype(npdt)
    jconfig, jstate, tconfig, tstate = _start_kl_both(d, bs, jimpl, timpl, dtype, flags)
    nb, latent = n // bs, tconfig.latent_size
    assert latent == jconfig.latent_size
    jl, tl = [], []
    for phase in phases:
        perm = rng.permutation(n)
        noise = rng.normal(size=(nb, bs, latent)).astype(npdt)
        jfn = JS.kl_detector_epoch if phase == D else JS.kl_generator_epoch
        tfn = TS.kl_detector_epoch if phase == D else TS.kl_generator_epoch
        jstate, loss = jfn(jstate, jnp.asarray(x), jconfig,
                           rng=(jnp.asarray(perm), jnp.asarray(noise)))
        jl.append(float(loss))
        tstate, loss = tfn(tstate, torch.from_numpy(x), tconfig,
                           rng=(torch.from_numpy(perm), torch.from_numpy(noise)))
        tl.append(float(loss))
    return jstate, tstate, np.asarray(jl), np.asarray(tl)


def _assert_kl_params(jstate, tstate, rtol, atol):
    pairs = ((generator_state_dict_from_jax(_np_tree(jstate.gen_params)), tstate.generator),
             (detector_state_dict_from_jax(_np_tree(jstate.det_params)), tstate.detector))
    for want, module in pairs:
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                       err_msg=name)


FLAGS = {
    "quirks on": {},
    "generator trains": {"replicate_generator_detach": False},
    "encoder never frozen": {"replicate_encoder_freeze": False},
    "elm": {"elm": True},
}


@pytest.mark.parametrize("flags", list(FLAGS.values()), ids=list(FLAGS))
def test_kl_lockstep_float64(flags):
    """Phases D, G, G, D on the dense paths ('jnp' and 'torch'), float64:
    the encoder freeze after the first generator epoch, the detached or
    training generator and ``elm`` as in JAX."""
    jstate, tstate, jl, tl = _kl_lockstep([D, G, G, D], 40, 48, 10, "jnp", "torch",
                                          torch.float64, flags, seed=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    _assert_kl_params(jstate, tstate, rtol=1e-8, atol=1e-12)
    assert bool(tstate.encoder_active) == bool(jstate.encoder_active) is False
    np.testing.assert_allclose(float(tstate.bw_value), float(jstate.bw_value), rtol=1e-12)


def test_kl_lockstep_kernel_paths_float32():
    """Phases D, G: Pallas in interpret mode against the port's kernel
    Function on its plain versions (the flash regime of the encodings),
    float32, generator training."""
    jstate, tstate, jl, tl = _kl_lockstep([D, G], 30, 64, 10, "pallas", "cuda",
                                          torch.float32, {"replicate_generator_detach": False},
                                          seed=1)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    _assert_kl_params(jstate, tstate, rtol=2e-4, atol=1e-6)


def test_kl_train_epochs_history_semantics():
    """Each epoch records the most recent loss of each kind, NaN before the
    first epoch of that kind; an idle epoch changes nothing."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(30, 16)))
    config = TS.TrainConfig(ndims=16, batch_size=10, mmd_impl="torch")
    phases = np.array([G, G, D, TS.PHASE_IDLE, G], dtype=np.int32)
    state, det, gen = TS.kl_fit_program(x, 11, phases, config)
    assert det.shape == gen.shape == (5,) and det.dtype == torch.float32
    det, gen = det.numpy(), gen.numpy()
    assert np.isnan(det[:2]).all() and np.isfinite(det[2:]).all()
    assert det[2] == det[3] == det[4]
    assert np.isfinite(gen).all() and gen[2] == gen[3] == gen[1]
    assert bool(state.bw_is_set) and not bool(state.encoder_active)
    _, det2, gen2 = TS.kl_fit_program(x, 11, phases, config)
    np.testing.assert_array_equal(det2.numpy(), det)
    np.testing.assert_array_equal(gen2.numpy(), gen)
