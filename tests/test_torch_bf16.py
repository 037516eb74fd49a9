"""The port's bf16 options (``gram_matmul_dtype``, ``model_matmul_dtype``,
``opt_state_dtype``) against ``vgan_tpu`` with the same options, on the CPU
(Pallas in interpret mode).

Tolerances, each with its reason:

- distances and MMD values with ``matmul_dtype='bfloat16'``: both sides take
  float32 products of the same bf16-rounded operands, which are exact, so
  they differ only in the float32 summation order: ``RTOL`` 1e-5, with an
  absolute floor of 1e-5 of the norms' scale where d2 cancels;
- gradients: signed sums that partly cancel, held to ``GRAD_FRAC`` 1e-4 of
  their largest entry (test_torch_mmd_gram.py's f32 tolerances, tighter);
- each of the three operand asymmetries of the JAX backward is pinned by
  showing that the other choice of z lies more than ``SEPARATION`` times
  the tolerance away from JAX, while the port lies within it;
- the bf16 layers: each layer's float32 sum is rounded to bf16, and a sum
  taken in another order rounds to the neighbouring bf16 value when it
  lies within a few float32 ulps of a rounding boundary: the logits agree
  within ``LOGIT_ULPS`` bf16 ulps (2^-8 relative) of their largest entry,
  and a mask bit may differ only where its float32 logit lies within that
  limit of the upper softmax's threshold;
- the bf16 Adadelta state: the float32 math of both sides agrees to the
  bit on these inputs, and both round to nearest even, so the stored state
  is equal to the bit and the parameters within 1e-7;
- the fits: the bf16 roundings of the layers amplify float32 summation
  differences to bf16 resolution (see above) wherever a value lies near a
  rounding boundary, so a few steps' losses are held within ``FIT_RTOL``
  2e-3, half a bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ops.pallas.mmd_gram as JG
from vgan_tpu.models.detector import Detector as JDetector
from vgan_tpu.models.generator import GeneratorBig as JGenerator
from vgan_tpu.ops import mmd as JM
from vgan_tpu.train import steps as JS
from vgan_tpu.train.adadelta import adadelta as jax_adadelta
from vgan_tpu_torch import VGAN_no_kl
from vgan_tpu_torch.interop import (
    adadelta_state_from_jax,
    detector_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from vgan_tpu_torch.models.detector import Detector
from vgan_tpu_torch.models.generator import GeneratorBig
from vgan_tpu_torch.ops import mmd as TM
from vgan_tpu_torch.ops.activations import binarize_mask
from vgan_tpu_torch.ops.cuda import mmd_gram as TG
from vgan_tpu_torch.train import adadelta as TA
from vgan_tpu_torch.train import steps as TS

BF16 = "bfloat16"
RTOL = 1e-5
GRAD_FRAC = 1e-4
SEPARATION = 10.0
LOGIT_ULPS = 4
FIT_RTOL = 2e-3
MULTS = JM.bandwidth_multipliers()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(n1, n2, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n1, d)).astype(np.float32)
    y = (rng.normal(size=(n2, d)) * (rng.random(d) < 0.6) + 0.2).astype(np.float32)
    return x, y


def _frac(got, want) -> float:
    """Largest entry of |got - want| as a fraction of max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# the MMD: dense, chunked and kernel paths
# ---------------------------------------------------------------------------


def test_pairwise_sq_dists_bf16_matches_jax_and_keeps_f32_norms():
    x, y = _pair(17, 13, 40)
    got = TM.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y), matmul_dtype=BF16)
    want = np.asarray(JM.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y), matmul_dtype=BF16))
    scale = float(np.max(np.sum(x * x, 1)) + np.max(np.sum(y * y, 1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6 * scale)
    # a row's own distance is not 0 before the clamp: the norms are the f32 rows'
    own = TM.pairwise_sq_dists(torch.from_numpy(x), matmul_dtype=BF16).diagonal()
    own_j = np.diagonal(np.asarray(JM.pairwise_sq_dists(jnp.asarray(x), matmul_dtype=BF16)))
    assert np.count_nonzero(own_j) > 0 and np.count_nonzero(own.numpy()) > 0
    with pytest.raises(ValueError):
        TM.pairwise_sq_dists(torch.from_numpy(x), matmul_dtype="float16")


@pytest.mark.parametrize("impl", ["torch", "chunked"])
def test_mmd_bf16_value_and_grad_match_jax(impl):
    """The dense and the chunked (row blocks of 8) paths: value and the
    gradient, whose operand cotangents round to bf16 on both sides."""
    x, y = _pair(23, 19, 40, seed=3)
    bw = 30.0

    def jf(a, b):
        if impl == "chunked":
            return JM.mmd2_biased_chunked(a, b, jnp.asarray(bw), jnp.asarray(True), row_block=8,
                                          matmul_dtype=BF16)[0]
        return JM.mmd2_biased_stateful(a, b, jnp.asarray(bw), jnp.asarray(True), impl="jnp",
                                       matmul_dtype=BF16)[0]

    vj = float(jf(jnp.asarray(x), jnp.asarray(y)))
    gxj, gyj = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    bw_t, on = torch.tensor(bw), torch.tensor(True)
    if impl == "chunked":
        vt, _ = TM.mmd2_biased_chunked(xt, yt, bw_t, on, row_block=8, matmul_dtype=BF16)
    else:
        vt, _ = TM.mmd2_biased_stateful(xt, yt, bw_t, on, impl="torch", matmul_dtype=BF16)
    gxt, gyt = torch.autograd.grad(vt, (xt, yt))
    np.testing.assert_allclose(float(vt.detach()), vj, rtol=RTOL)
    assert _frac(gxt, gxj) < GRAD_FRAC and _frac(gyt, gyj) < GRAD_FRAC
    # and it is not the f32 MMD: the option changes the value
    vf, _ = TM.mmd2_biased_stateful(torch.from_numpy(x), torch.from_numpy(y), bw_t, on)
    assert abs(float(vf) - vj) > SEPARATION * RTOL * abs(vj)


def _jax_core(x, y, bw):
    def f(a, b):
        return JG.mmd2_biased_pallas(a, b, bandwidth=bw, matmul_dtype=BF16)[0]

    v = f(jnp.asarray(x), jnp.asarray(y))
    gx, gy = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    return float(v), np.asarray(gx), np.asarray(gy)


@pytest.mark.parametrize("regime,n1,n2,d", [
    ("flash", 33, 17, 40),
    ("flash", 20, 28, 600),
    ("stash", 40, 30, 2100),
    ("panel", 40, 30, 2100),
])
def test_mmd2_core_bf16_vs_pallas(monkeypatch, regime, n1, n2, d):
    """``impl='cuda'`` with ``matmul_dtype='bfloat16'`` (the bf16 variants'
    plain versions, the regime as JAX picks it) against
    ``mmd2_biased_pallas(matmul_dtype='bfloat16')`` in interpret mode; only
    the bf16 wrappers are called, and none launches on the CPU."""
    if regime == "panel":
        monkeypatch.setattr(JG, "_KP_STASH_BYTES", 0)
        monkeypatch.setattr(TG, "_KP_STASH_BYTES", 0)
    assert TG.regime(n1 + n2, d) == regime
    x, y = _pair(n1, n2, d, seed=1)
    bw = float(d)
    vj, gxj, gyj = _jax_core(x, y, jnp.asarray(bw, jnp.float32))
    called = []

    def recorded(fn):
        def wrapper(*args, **kwargs):
            called.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    for fn in TG.KERNELS + TG.BF16_KERNELS:
        monkeypatch.setattr(TG, fn.__name__, recorded(fn))
    TG.reset_launch_counts()
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    vt, _ = TM.mmd2_biased_stateful(xt, yt, torch.tensor(bw), torch.tensor(True), impl="cuda",
                                    matmul_dtype=BF16)
    gxt, gyt = torch.autograd.grad(vt, (xt, yt))
    assert sum(TG.launch_counts().values()) == 0, "no kernel launches on CPU tensors"
    assert called and all(n.endswith("_bf16") for n in called), called
    np.testing.assert_allclose(float(vt.detach()), vj, rtol=RTOL)
    assert _frac(gxt, gxj) < GRAD_FRAC and _frac(gyt, gyj) < GRAD_FRAC


def _z_norms(x, y):
    z = torch.from_numpy(np.concatenate([x, y]))
    return z, torch.sum(z * z, dim=1)


def test_asymmetry_norms_from_the_f32_rows():
    """K1's bf16 variant takes the f32 rows' norms beside the rounded
    product, as the Pallas forward does; norms of the rounded rows miss JAX's
    quadrant sums by far more than the tolerance."""
    n1, n2, d = 33, 17, 40
    x, y = _pair(n1, n2, d, seed=4)
    z_pad, norms_pad, _, _, m, tile_d = JG._pad_z(jnp.asarray(x), jnp.asarray(y))
    bw = jnp.asarray(float(d), jnp.float32)
    want = np.asarray(JG._gram_quadrant_sums(
        JG._dot_operand(z_pad, BF16), norms_pad, bw, n1, m, MULTS, tile_d,
        tile_m=JG._fwd_tile(z_pad.shape[0], tile_d, 2), interpret=True))[0, :3]
    z, norms = _z_norms(x, y)
    bw_t = torch.tensor(float(d))
    got = TG.gram_quadrant_sums_bf16(z, norms, bw_t, n1, MULTS).numpy()[0, :3]
    zr = TG.rounded(z)
    other = TG.gram_quadrant_sums_bf16(z, torch.sum(zr * zr, 1), bw_t, n1, MULTS).numpy()[0, :3]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.max(np.abs(other - want) / np.abs(want)) > SEPARATION * RTOL


def _coeff(n1, n2):
    cxx, cyy, cxy = TG._coefficients(n1, n2)
    c = torch.full((n1 + n2, n1 + n2), cxy)
    c[:n1, :n1], c[n1:, n1:] = cxx, cyy
    return c


def test_asymmetry_flash_s_times_the_rounded_rows():
    """K3's bf16 variant multiplies S with the rounded z (the Pallas kernel
    upcasts its bf16 z block); S @ z on the f32 rows misses JAX's ``sz``."""
    n1, n2, d = 33, 17, 40
    x, y = _pair(n1, n2, d, seed=5)
    z_pad, norms_pad, _, _, m, _ = JG._pad_z(jnp.asarray(x), jnp.asarray(y))
    bw = float(d)
    sz_j, rs_j = JG._gram_backward_flash(JG._dot_operand(z_pad, BF16), norms_pad,
                                         jnp.asarray(bw, jnp.float32), n1, n2, m, MULTS,
                                         interpret=True)
    sz_j, rs_j = np.asarray(sz_j)[:m, :d], np.asarray(rs_j)[:m]
    z, norms = _z_norms(x, y)
    sz, rs = TG.gram_backward_flash_bf16(z, norms, torch.tensor(bw), n1, n2, MULTS)
    assert _frac(sz, sz_j) < GRAD_FRAC and _frac(rs, rs_j) < GRAD_FRAC
    zr = TG.rounded(z)
    s = _coeff(n1, n2) * TG._kernel_deriv(TG._sq_dists(zr, zr, norms, norms), torch.tensor(bw),
                                          MULTS)
    assert _frac(s @ z, sz_j) > SEPARATION * GRAD_FRAC
    # and the cotangent's rowsum(S) z term is the f32 rows', as JAX's
    g_j = np.asarray(jax.grad(lambda b: JG.mmd2_biased_pallas(
        jnp.asarray(x), b, bandwidth=jnp.asarray(bw, jnp.float32), matmul_dtype=BF16)[0])(
        jnp.asarray(y)))
    dz_other = 4.0 * (rs * zr - sz)
    assert _frac(dz_other[n1:], g_j) > SEPARATION * GRAD_FRAC


@pytest.mark.parametrize("regime", ["stash", "panel"])
def test_asymmetry_stash_and_panel_contract_the_f32_rows(monkeypatch, regime):
    """The stash and panel backwards contract K' (from the rounded rows)
    with the f32 z, as JAX's do; the same contraction with the rounded z
    misses JAX's gradient by far more than the tolerance."""
    if regime == "panel":
        monkeypatch.setattr(JG, "_KP_STASH_BYTES", 0)
        monkeypatch.setattr(TG, "_KP_STASH_BYTES", 0)
    n1, n2, d = 40, 30, 2100
    assert TG.regime(n1 + n2, d) == regime
    x, y = _pair(n1, n2, d, seed=6)
    bw = float(d)
    _, gxj, gyj = _jax_core(x, y, jnp.asarray(bw, jnp.float32))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    v, _ = TG.mmd2_biased_cuda(xt, yt, bandwidth=bw, matmul_dtype=BF16)
    gx, gy = torch.autograd.grad(v, (xt, yt))
    assert _frac(gx, gxj) < GRAD_FRAC and _frac(gy, gyj) < GRAD_FRAC
    z, norms = _z_norms(x, y)
    zr = TG.rounded(z)
    m = n1 + n2
    q = TG._q_vector(m, n1, "cpu")
    kp = TG._kernel_deriv(TG._sq_dists(zr, zr, norms, norms), torch.tensor(bw), MULTS)
    other = 4.0 * q[:, None] * ((kp @ q)[:, None] * zr - kp @ (q[:, None] * zr))
    assert _frac(other[:n1], gxj) > SEPARATION * GRAD_FRAC


# ---------------------------------------------------------------------------
# the bf16 layers
# ---------------------------------------------------------------------------


def _logit_limit(h_j) -> float:
    return LOGIT_ULPS * 2.0 ** -8 * float(np.max(np.abs(h_j)))


def test_generator_bf16_compute_matches_flax():
    d, latent, n = 48, 3, 64
    jgen = JGenerator(out_features=d, latent_size=latent, compute_dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(2), jnp.zeros((1, latent), jnp.float32))
    z = np.random.default_rng(3).normal(size=(n, latent)).astype(np.float32)
    u_j, inter = jgen.apply(params, jnp.asarray(z), capture_intermediates=True)
    h_j = np.asarray(inter["intermediates"]["Dense_3"]["__call__"][0]).astype(np.float32)
    tgen = GeneratorBig(d, latent, compute_dtype=torch.bfloat16)
    tgen.load_state_dict(generator_state_dict_from_jax(_np_tree(params)))
    assert all(p.dtype == torch.float32 for p in tgen.parameters()), "f32 master parameters"
    from vgan_tpu_torch.models.generator import linear_stack

    h_t = linear_stack(tgen.main, torch.from_numpy(z), torch.bfloat16)
    assert h_t.dtype == torch.float32
    lim = _logit_limit(h_j)
    assert float(np.max(np.abs(h_t.detach().numpy() - h_j))) <= lim
    # the masks: equal except where the f32 logit is within the limit of the
    # upper softmax's threshold (softmax_i >= 1/d  <=>  h_i >= lse(h) - log d)
    margin = h_j - (jax.scipy.special.logsumexp(h_j, axis=-1, keepdims=True) - np.log(d))
    exposed = np.abs(np.asarray(margin)) <= 2 * lim
    m_t = binarize_mask(tgen.sample(torch.from_numpy(z)), axis=-1).numpy()
    m_j = np.asarray(u_j) >= 1.0 / d
    assert np.array_equal(m_t[~exposed], m_j[~exposed])
    assert (~exposed).mean() > 0.5
    # bf16 compute is not the f32 forward
    f32 = GeneratorBig(d, latent)
    f32.load_state_dict(tgen.state_dict())
    assert not torch.equal(linear_stack(f32.main, torch.from_numpy(z), None), h_t)


def test_detector_bf16_compute_matches_flax():
    d, latent, n = 40, 3, 16
    jdet = JDetector(latent_size=latent, in_features=d, compute_dtype=jnp.bfloat16)
    params = jdet.init(jax.random.PRNGKey(1), jnp.zeros((1, d), jnp.float32))
    x = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
    enc_j, dec_j = jdet.apply(params, jnp.asarray(x))
    assert enc_j.dtype == dec_j.dtype == jnp.float32
    tdet = Detector(latent, d, compute_dtype=torch.bfloat16)
    tdet.load_state_dict(detector_state_dict_from_jax(_np_tree(params)))
    enc_t, dec_t = tdet(torch.from_numpy(x))
    assert enc_t.dtype == dec_t.dtype == torch.float32
    for got, want in ((enc_t, enc_j), (dec_t, dec_j)):
        want = np.asarray(want)
        assert float(np.max(np.abs(got.detach().numpy() - want))) <= _logit_limit(want)


# ---------------------------------------------------------------------------
# the bf16 Adadelta state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [None, True, False, "device True", "device False"])
def test_adadelta_bf16_state_matches_jax(flag):
    """Three updates on the same float32 grads: the stored bf16 state equal
    to JAX's to the bit (both round to nearest even), the parameters within
    1e-7; a leaf's flag as a host bool or a device tensor."""
    rng = np.random.default_rng(5)
    shapes = {"encoder.main.0.weight": (6, 5), "decoder.main.0.bias": (6,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = jax_adadelta(0.007, weight_decay=0.04, state_dtype=BF16)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    topt = TA.Adadelta(0.007, weight_decay=0.04, state_dtype=BF16)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tparams)
    assert all(t.dtype == torch.bfloat16 for t in tstate.square_avg.values())
    on = flag not in (False, "device False")
    jactive = {"encoder.main.0.weight": jnp.asarray(on), "decoder.main.0.bias": True}
    tactive = None if flag is None else {
        "encoder.main.0.weight": flag if isinstance(flag, bool) else torch.tensor(on)}
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams,
                                  active=jactive if flag is not None else None)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        topt.step(tparams, [torch.from_numpy(grads[k]) for k in tparams], tstate, active=tactive)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-7)
        for mine, theirs in ((tstate.square_avg[k], jstate.square_avg[k]),
                             (tstate.acc_delta[k], jstate.acc_delta[k])):
            assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
            np.testing.assert_array_equal(mine.float().numpy(),
                                          np.asarray(theirs).astype(np.float32))
    with pytest.raises(ValueError):
        TA.Adadelta(0.007, state_dtype="float16")


# ---------------------------------------------------------------------------
# the fits, in lockstep with vgan_tpu (injected draws), and against f32
# ---------------------------------------------------------------------------

OPTIONS = dict(gram_matmul_dtype=BF16, model_matmul_dtype=BF16, opt_state_dtype=BF16)


def _carry_opt(jopt):
    return adadelta_state_from_jax(_np_tree(jopt.square_avg), _np_tree(jopt.acc_delta))


def test_no_kl_bf16_fit_lockstep_with_jax():
    """Three epochs of 2 batches with all three options, the kernel paths
    (Pallas interpret mode against the bf16 variants' plain versions, flash
    regime at d=600)."""
    n, d, bs = 24, 600, 12
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    jconfig = JS.TrainConfig(ndims=d, batch_size=bs, mmd_impl="pallas", **OPTIONS)
    jstate = JS.init_no_kl_state(jconfig, jax.random.PRNGKey(3))
    tconfig = TS.TrainConfig(ndims=d, batch_size=bs, mmd_impl="cuda", **OPTIONS)
    tstate = TS.init_no_kl_state(tconfig, 0, "cpu")
    tstate.generator.load_state_dict(generator_state_dict_from_jax(_np_tree(jstate.params)))
    tstate.opt_state = _carry_opt(jstate.opt_state)
    # JAX's bf16 leaves reach the port as ml_dtypes bf16 arrays, or as float32
    # arrays with state_dtype='bfloat16': the same bf16 state either way
    as_f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), _np_tree(jstate.opt_state))
    again = adadelta_state_from_jax(as_f32.square_avg, as_f32.acc_delta, state_dtype=BF16)
    for mine, theirs in zip(tstate.opt_state, again):
        assert all(mine[k].dtype == torch.bfloat16 and torch.equal(mine[k], theirs[k])
                   for k in mine)
    assert tstate.generator.compute_dtype == torch.bfloat16
    jl, tl = [], []
    for _ in range(3):
        perm = rng.permutation(n)
        noise = rng.normal(size=(n // bs, bs, tconfig.latent_size)).astype(np.float32)
        jstate, loss = JS._no_kl_epoch_body(jstate, jnp.asarray(x), jconfig,
                                            rng=(jnp.asarray(perm), jnp.asarray(noise)))
        jl.append(float(loss))
        tstate, loss = TS.no_kl_epoch(tstate, torch.from_numpy(x), tconfig,
                                      rng=(torch.from_numpy(perm), torch.from_numpy(noise)))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=FIT_RTOL)
    assert all(t.dtype == torch.bfloat16 for t in tstate.opt_state.acc_delta.values())


def test_kl_bf16_fit_lockstep_with_jax():
    """Phases D, G (the generator training), all three options, dense paths."""
    n, d, bs = 30, 64, 10
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, d)).astype(np.float32)
    flags = dict(replicate_generator_detach=False, **OPTIONS)
    jconfig = JS.TrainConfig(ndims=d, batch_size=bs, mmd_impl="jnp", scan_unroll=1, **flags)
    jstate = JS.init_kl_state(jconfig, jax.random.PRNGKey(3))
    tconfig = TS.TrainConfig(ndims=d, batch_size=bs, mmd_impl="torch", **flags)
    tstate = TS.init_kl_state(tconfig, 0, "cpu")
    tstate.generator.load_state_dict(generator_state_dict_from_jax(_np_tree(jstate.gen_params)))
    tstate.detector.load_state_dict(detector_state_dict_from_jax(_np_tree(jstate.det_params)))
    tstate.gen_opt, tstate.det_opt = _carry_opt(jstate.gen_opt), _carry_opt(jstate.det_opt)
    jl, tl = [], []
    for phase in (TS.PHASE_DETECTOR, TS.PHASE_GENERATOR):
        perm = rng.permutation(n)
        noise = rng.normal(size=(n // bs, bs, tconfig.latent_size)).astype(np.float32)
        jfn = JS.kl_detector_epoch if phase == TS.PHASE_DETECTOR else JS.kl_generator_epoch
        tfn = TS.kl_detector_epoch if phase == TS.PHASE_DETECTOR else TS.kl_generator_epoch
        jstate, loss = jfn(jstate, jnp.asarray(x), jconfig,
                           rng=(jnp.asarray(perm), jnp.asarray(noise)))
        jl.append(float(loss))
        tstate, loss = tfn(tstate, torch.from_numpy(x), tconfig,
                           rng=(torch.from_numpy(perm), torch.from_numpy(noise)))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=FIT_RTOL)
    assert all(t.dtype == torch.bfloat16 for t in tstate.det_opt.square_avg.values())


def test_bf16_model_and_opt_state_fit_close_to_f32():
    """The port's mirror of vgan_tpu's test_bf16_model_and_opt_state_fit_close_to_f32:
    the bf16 fit within rtol 0.08 of the f32 fit, the binarized masks of a
    shared noise batch agreeing above 0.97, the state dtypes as asked."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(128, 32)).astype(np.float32))
    cfg32 = TS.TrainConfig(ndims=32, batch_size=32, lr_g=0.01)
    cfg16 = TS.TrainConfig(ndims=32, batch_size=32, lr_g=0.01,
                           model_matmul_dtype=BF16, opt_state_dtype=BF16)
    st32, losses32 = TS.no_kl_fit_program(x, 3, cfg32, 6)
    st16, losses16 = TS.no_kl_fit_program(x, 3, cfg16, 6)
    assert torch.all(torch.isfinite(losses16))
    np.testing.assert_allclose(losses16.numpy(), losses32.numpy(), rtol=0.08)
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(64, cfg32.latent_size))
                         .astype(np.float32))
    with torch.no_grad():
        m32 = binarize_mask(st32.generator.sample(z), axis=-1)
        m16 = binarize_mask(st16.generator.sample(z), axis=-1)
    assert float((m32 == m16).float().mean()) > 0.97
    assert next(iter(st16.opt_state.square_avg.values())).dtype == torch.bfloat16
    assert next(iter(st32.opt_state.square_avg.values())).dtype == torch.float32


# ---------------------------------------------------------------------------
# checkpoints, the fused fit, serving and the CLI
# ---------------------------------------------------------------------------


def test_bf16_opt_state_checkpoint_roundtrip(tmp_path):
    """The port's mirror of vgan_tpu's test_bf16_opt_state_checkpoint_roundtrip:
    the bf16 state is stored as bf16 and a resumed fit continues the
    uninterrupted one to the bit."""
    x = np.random.default_rng(4).normal(size=(96, 10)).astype(np.float32)
    kw = dict(batch_size=32, verbose=False, opt_state_dtype=BF16, model_matmul_dtype=BF16,
              device="cpu")
    full = VGAN_no_kl(epochs=6, **kw).fit(x)
    a = VGAN_no_kl(epochs=3, **kw).fit(x)
    assert next(iter(a.train_state.opt_state.square_avg.values())).dtype == torch.bfloat16
    a.save_checkpoint(tmp_path / "ckpt")
    b = VGAN_no_kl(epochs=3, **kw)
    b.restore_checkpoint(tmp_path / "ckpt")
    for mine, theirs in zip(b.train_state.opt_state, a.train_state.opt_state):
        for k in mine:
            assert mine[k].dtype == torch.bfloat16 and torch.equal(mine[k], theirs[k])
    b.continue_fit(x, 3)
    np.testing.assert_array_equal(b.train_history["generator_loss"],
                                  full.train_history["generator_loss"])
    np.testing.assert_array_equal(b.generate_subspaces(16), full.generate_subspaces(16))


@pytest.mark.parametrize("option", ["model_matmul_dtype", "opt_state_dtype"])
def test_fused_fit_refuses_the_model_and_state_dtypes(option):
    x = np.random.default_rng(7).normal(size=(128, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="fit_impl='scan'"):
        VGAN_no_kl(epochs=1, batch_size=64, fit_impl="fused", verbose=False, device="cpu",
                   **{option: BF16}).fit(x)


def test_fused_fit_ignores_the_gram_dtype():
    """As in vgan_tpu: the fused kernel runs f32 whatever gram_matmul_dtype
    asks (ROADMAP Queue 3), so the losses equal the f32 fused fit's."""
    x = np.random.default_rng(7).normal(size=(128, 16)).astype(np.float32)
    kw = dict(epochs=2, batch_size=64, fit_impl="fused", verbose=False, device="cpu")
    a = VGAN_no_kl(gram_matmul_dtype=BF16, **kw).fit(x)
    b = VGAN_no_kl(**kw).fit(x)
    assert a.gram_matmul_dtype == BF16
    np.testing.assert_array_equal(a.train_history["generator_loss"],
                                  b.train_history["generator_loss"])


def test_exported_bf16_sampler_equals_the_live_one(tmp_path):
    from vgan_tpu_torch.serving import export_sampler, load_sampler, sample_masks

    x = np.random.default_rng(8).normal(size=(64, 40)).astype(np.float32)
    model = VGAN_no_kl(epochs=1, batch_size=32, verbose=False, device="cpu",
                       model_matmul_dtype=BF16).fit(x)
    assert model.generator.compute_dtype == torch.bfloat16
    export_sampler(model, tmp_path / "sampler.pt2")
    got = sample_masks(load_sampler(tmp_path / "sampler.pt2"), 200, model._latent_size,
                       seed=model.seed)
    np.testing.assert_array_equal(got, model.generate_subspaces(200))


def test_cli_fit_with_the_bf16_flags(tmp_path):
    from vgan_tpu_torch import cli as TCLI

    path = tmp_path / "x.npy"
    np.save(path, np.random.default_rng(9).normal(size=(64, 12)).astype(np.float32))
    out = TCLI.main(["fit", "--data", str(path), "--epochs", "1", "--batch-size", "32",
                     "--device", "cpu", "--quiet", "--gram-dtype", BF16, "--model-dtype", BF16,
                     "--opt-state-dtype", BF16, "--out", str(tmp_path / "run")])
    assert (tmp_path / "run" / "models" / "generator_0.pt").is_file()
    del out


@pytest.mark.parametrize("kernel", ["K2 bf16", "K1 bf16 sliced", "K1 bf16 one CTA", "K3 bf16"])
def test_bf16_scratch_holds_z_in_half_the_floats(kernel):
    """The bf16 variants' copy of z takes half the floats of the f32 z: K1
    bf16 and K2 bf16 (``bf16_forward_scratch_floats``: the row-major
    rounded copy and three sums a CTA of their clusters: K2 bf16 at the
    stress Gram, K1 bf16 at the kl Gram, both three CTAs a pair, and at one);
    K3 bf16 (``flash_bf16_scratch_floats``: the same row-major rounded copy
    and the partial outputs of its later splits, three at the kl Gram)."""
    m, d = 1000, 10240 if kernel == "K2 bf16" else 640
    if kernel == "K3 bf16":
        _, _, nsplit = TG.flash_cluster_schedule(m, d, 132)
        assert nsplit == 3
        partials = (nsplit - 1) * m * (d + 1)
        assert TG.flash_bf16_scratch_floats(m, d, nsplit) - partials == m * d // 2
        return
    slices = 1 if kernel == "K1 bf16 one CTA" else TG.cluster_schedule(TG.tile_pairs(m), d, 132)[0]
    assert slices == (1 if kernel == "K1 bf16 one CTA" else 3)
    sums = 3 * TG.tile_pairs(m) * slices
    assert TG.bf16_forward_scratch_floats(m, d, slices) - sums == m * d // 2


def test_split_bf16x3_reconstructs_f32_exactly():
    """K3 bf16's three-term split of S (``split_bf16x3``, the plain version
    of the kernel's): hi + mid + lo equals each float32 value to the bit,
    over magnitudes from 1e-30 to 1e30 and both signs, each term a bf16
    value; hi alone is the value rounded to bf16, and mid, lo shrink by at
    least 2^8 a step."""
    rng = np.random.default_rng(17)
    s = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    s = torch.from_numpy(np.concatenate([s, np.float32([0.0, 1.0, -1.0, 3.0e-33])]))
    hi, mid, lo = TG.split_bf16x3(s)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), s)
    assert torch.equal(hi, s.to(torch.bfloat16))
    big = torch.abs(s) > 1e-30
    assert torch.all(torch.abs(mid.float()[big]) <= torch.abs(hi.float()[big]) * 2.0 ** -8)
    assert torch.all(torch.abs(lo.float()[big]) <= torch.abs(mid.float()[big]) * 2.0 ** -8)
