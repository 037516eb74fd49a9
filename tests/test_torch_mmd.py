"""The port's MMD loss (``vgan_tpu_torch.ops.mmd``) against ``vgan_tpu.ops.mmd``,
in float64 at rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.ops import mmd as JM
from vgan_tpu_torch.ops import mmd as TM

RTOL = 1e-10
GEOMETRIC = JM.bandwidth_multipliers()
NON_GEOMETRIC = (0.3, 1.0, 2.7)


def _pair(seed, n1=14, n2=11, d=6, offset=0.3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n1, d)), rng.normal(size=(n2, d)) + offset


def _t(a):
    return torch.tensor(np.asarray(a))


def test_bandwidth_multipliers_and_ladder():
    assert TM.bandwidth_multipliers() == JM.bandwidth_multipliers()
    assert TM.bandwidth_multipliers(7, 3.0) == JM.bandwidth_multipliers(7, 3.0)
    for mults in (GEOMETRIC, NON_GEOMETRIC, (1.0, 0.5)):
        assert TM.ladder_exponents(mults) == JM.ladder_exponents(mults)


def test_integer_powers():
    t = np.random.default_rng(0).random(10)
    ints = (16, 8, 4, 2, 1, 3, 7)
    for a, b in zip(TM.integer_powers(_t(t), ints), JM.integer_powers(jnp.asarray(t), ints)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pairwise_sq_dists_and_bandwidths():
    x, y = _pair(1)
    np.testing.assert_allclose(
        TM.pairwise_sq_dists(_t(x), _t(y)).numpy(),
        np.asarray(JM.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)
    d2 = TM.pairwise_sq_dists(_t(x))
    np.testing.assert_allclose(
        float(TM.reference_bandwidth(d2)),
        float(JM.reference_bandwidth(JM.pairwise_sq_dists(jnp.asarray(x)))), rtol=RTOL)
    z = np.concatenate([x, y]) + 100.0  # off-center: the closed form is translation-invariant
    np.testing.assert_allclose(
        float(TM.candidate_bandwidth(_t(z))), float(JM.candidate_bandwidth(jnp.asarray(z))),
        rtol=RTOL)


@pytest.mark.parametrize("mults", [GEOMETRIC, NON_GEOMETRIC])
def test_multi_rbf_gram(mults):
    x, _ = _pair(2)
    d2 = np.asarray(JM.pairwise_sq_dists(jnp.asarray(x)))
    np.testing.assert_allclose(
        TM.multi_rbf_gram(_t(d2), torch.tensor(3.0, dtype=torch.float64), mults).numpy(),
        np.asarray(JM.multi_rbf_gram(jnp.asarray(d2), jnp.asarray(3.0), mults)), rtol=RTOL)


@pytest.mark.parametrize("bandwidth", [None, 4.5])
@pytest.mark.parametrize("mults", [GEOMETRIC, NON_GEOMETRIC])
def test_mmd2_biased_value(bandwidth, mults):
    x, y = _pair(3)
    vj, bj = JM.mmd2_biased(jnp.asarray(x), jnp.asarray(y), bandwidth, mults)
    vt, bt = TM.mmd2_biased(_t(x), _t(y), bandwidth, mults)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    np.testing.assert_allclose(float(bt), float(bj), rtol=RTOL)


@pytest.mark.parametrize("is_set", [False, True])
def test_mmd2_biased_stateful_grads(is_set):
    """Value and gradient w.r.t. x and y, with the bandwidth state threaded."""
    x, y = _pair(4)
    bw_value, bw_is_set = 2.5, is_set

    def jf(a, b):
        return JM.mmd2_biased_stateful(
            a, b, jnp.asarray(bw_value), jnp.asarray(bw_is_set), impl="jnp")[0]

    gxj, gyj = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    vt, bt = TM.mmd2_biased_stateful(
        xt, yt, torch.tensor(bw_value, dtype=torch.float64), torch.tensor(bw_is_set))
    gxt, gyt = torch.autograd.grad(vt, (xt, yt))
    np.testing.assert_allclose(float(vt.detach()), float(jf(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)
    np.testing.assert_allclose(gxt.numpy(), np.asarray(gxj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(gyt.numpy(), np.asarray(gyj), rtol=RTOL, atol=1e-14)
    if is_set:
        assert float(bt) == bw_value


def test_mmd2_biased_chunked_value_and_grad():
    """Row blocks smaller than m, so several checkpointed blocks run."""
    x, y = _pair(5, n1=23, n2=19)
    bw_value, bw_is_set = jnp.asarray(0.0), jnp.asarray(False)

    def jf(b):
        return JM.mmd2_biased_chunked(jnp.asarray(x), b, bw_value, bw_is_set, row_block=8)[0]

    gj = jax.grad(jf)(jnp.asarray(y))
    yt = _t(y).requires_grad_()
    vt, bt = TM.mmd2_biased_chunked(
        _t(x), yt, torch.tensor(0.0, dtype=torch.float64), torch.tensor(False), row_block=8)
    (gt,) = torch.autograd.grad(vt, yt)
    np.testing.assert_allclose(float(vt), float(jf(jnp.asarray(y))), rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=1e-14)
    # and it equals the dense path
    vd, bd = TM.mmd2_biased(_t(x), _t(y))
    np.testing.assert_allclose(float(vt), float(vd), rtol=RTOL)
    np.testing.assert_allclose(float(bt), float(bd), rtol=RTOL)


def _penalty_grads(u):
    gj = np.asarray(jax.grad(JM.coverage_penalty)(jnp.asarray(u)))
    ut = _t(u).requires_grad_()
    vt = TM.coverage_penalty(ut)
    (gt,) = torch.autograd.grad(vt, ut)
    np.testing.assert_allclose(float(vt), float(JM.coverage_penalty(jnp.asarray(u))), rtol=RTOL)
    return gt.numpy(), gj


def test_coverage_penalty():
    u = np.random.default_rng(6).random((7, 5))
    gt, gj = _penalty_grads(u)
    np.testing.assert_allclose(gt, gj, rtol=RTOL)


def test_coverage_penalty_splits_ties_like_jax():
    """Tied column maxima (the snapped 1.0 entries of upper_softmax) share
    the gradient evenly, as jnp.max does; torch.max(dim=0) would not."""
    u = np.array([[1.0, 0.2, 1.0], [1.0, 0.7, 0.1], [0.3, 0.7, 1.0], [1.0, 0.1, 0.4]])
    gt, gj = _penalty_grads(u)
    np.testing.assert_allclose(gt, gj, rtol=RTOL)
    np.testing.assert_allclose(gt[:, 0], [-1 / 9, -1 / 9, 0.0, -1 / 9], rtol=RTOL)


@pytest.mark.parametrize("impl", ["torch", "chunked"])
def test_mmd_loss_constrained(impl):
    x, y = _pair(7)
    u = np.random.default_rng(8).random((14, 6))
    jimpl = {"torch": "jnp", "chunked": "chunked"}[impl]
    lj, bj = JM.mmd_loss_constrained(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(u), 10.0, impl=jimpl)
    lt, bt = TM.mmd_loss_constrained(_t(x), _t(y), _t(u), 10.0, impl=impl)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    np.testing.assert_allclose(float(bt), float(bj), rtol=RTOL)


def test_auto_on_cpu_takes_the_dense_path():
    """'auto' takes the kernels only for CUDA tensors (d >= 512 or m >= 4096)."""
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    G.reset_launch_counts()
    x, y = _pair(9, d=600)
    vt, _ = TM.mmd2_biased_stateful(
        _t(x), _t(y), torch.tensor(0.0, dtype=torch.float64), torch.tensor(False), impl="auto")
    vd, _ = TM.mmd2_biased(_t(x), _t(y))
    assert float(vt) == float(vd)
    assert not G.cuda_supported(_t(x), _t(y))
    assert sum(G.launch_counts().values()) == 0


def test_unknown_impl_and_bf16_raise():
    """An unknown impl raises; ``matmul_dtype='bfloat16'`` is ported (the
    distances from bf16-rounded operands and f32 norms, as JAX's; its paths
    are held to JAX in test_torch_bf16.py), and another matmul dtype raises."""
    x, y = _pair(10)
    with pytest.raises(ValueError):
        TM.mmd2_biased_stateful(_t(x), _t(y), torch.tensor(1.0), torch.tensor(True), impl="jnp")
    x32 = x.astype(np.float32)
    got = TM.pairwise_sq_dists(torch.from_numpy(x32), matmul_dtype="bfloat16")
    want = JM.pairwise_sq_dists(jnp.asarray(x32), matmul_dtype="bfloat16")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        TM.pairwise_sq_dists(_t(x), matmul_dtype="float16")
