"""The port's activations against ``vgan_tpu.ops.activations``, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgan_tpu.ops import activations as JA
from vgan_tpu_torch.ops import activations as TA

RTOL, ATOL = 1e-12, 1e-15


def _inputs(seed, shape=(6, 9)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) * 2.0, rng.normal(size=shape)


def _value_and_grad_jax(fn, x, w):
    def f(a):
        return jnp.sum(fn(a) * w)

    return np.asarray(fn(jnp.asarray(x))), np.asarray(jax.grad(f)(jnp.asarray(x)))


def _value_and_grad_torch(fn, x, w):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    (g,) = torch.autograd.grad(torch.sum(out * torch.tensor(w)), xt)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("name", ["upper_softmax", "upper_lower_softmax", "st_upper_softmax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_activation_value_and_grad(name, seed):
    x, w = _inputs(seed)
    vj, gj = _value_and_grad_jax(getattr(JA, name), x, w)
    vt, gt = _value_and_grad_torch(getattr(TA, name), x, w)
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)


def test_upper_softmax_mask_is_constant_in_gradient():
    """Snapped coordinates get zero local gradient, as in the reference."""
    x, _ = _inputs(3)
    xt = torch.tensor(x, requires_grad=True)
    out = TA.upper_softmax(xt)
    snapped = (out == 1.0).detach()
    assert snapped.any()
    w = torch.zeros_like(out)
    w[snapped] = 1.0
    (g,) = torch.autograd.grad(torch.sum(out * w), xt)
    assert torch.count_nonzero(g) == 0


def test_binarize_mask():
    x, _ = _inputs(4)
    u = np.asarray(JA.upper_softmax(jnp.asarray(x)))
    np.testing.assert_array_equal(
        TA.binarize_mask(torch.tensor(u)).numpy(), np.asarray(JA.binarize_mask(jnp.asarray(u)))
    )


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_gumbel_upper_softmax_injected_noise(hard, tau):
    x, w = _inputs(5)
    key = jax.random.PRNGKey(7)
    gumbel = np.asarray(jax.random.gumbel(key, x.shape, dtype=jnp.float64))
    vj, gj = _value_and_grad_jax(
        lambda a: JA.gumbel_upper_softmax(a, key, tau=tau, hard=hard), x, w)
    vt, gt = _value_and_grad_torch(
        lambda a: TA.gumbel_upper_softmax(a, torch.tensor(gumbel), tau=tau, hard=hard), x, w)
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)


def test_sample_gumbel_is_seeded_and_standard():
    g1 = TA.sample_gumbel((4000,), torch.Generator().manual_seed(3), torch.float64, "cpu")
    g2 = TA.sample_gumbel((4000,), torch.Generator().manual_seed(3), torch.float64, "cpu")
    assert torch.equal(g1, g2)
    # standard Gumbel: mean = Euler-Mascheroni constant, var = pi^2 / 6
    assert abs(float(g1.mean()) - 0.5772) < 0.06
    assert abs(float(g1.var()) - np.pi**2 / 6) < 0.15
