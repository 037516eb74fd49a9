"""Two-sample MMD goodness-of-fit test with permutation p-values.

Counterpart of ``vgan_tpu.ops.mmd_test``: kernel ``k(x, y) = sum_a
exp(-a |x - y|^2)`` over the given alphas, the unbiased statistic

    MMD_u = [sum_{i!=j} Kxx] / (n1 (n1-1)) + [sum_{i!=j} Kyy] / (n2 (n2-1))
            - 2 [sum Kxy] / (n1 n2)

and a permutation test whose permuted statistics all come from two batched
products against 0/1 indicator rows. Permutations come from a seeded
``torch.Generator`` (or are injected with ``permutations=``).

Past ``DENSE_GOF_MAX_M`` pooled samples (``DENSE_PRECISE_MAX_M`` on the
float64 path) the tests stream the Gram through the K5 kernel instead of
materializing it (``vgan_tpu_torch.ops.cuda.gof_gram``), with the same
statistic and permutation semantics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device
from vgan_tpu_torch.ops.mmd import pairwise_sq_dists

DENSE_GOF_MAX_M = 8192
DENSE_PRECISE_MAX_M = 16384


def alpha_gram(z: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """Pooled Gram ``sum_a exp(-a d2)`` over the stacked samples."""
    d2 = pairwise_sq_dists(z)
    k = torch.zeros_like(d2)
    for i in range(alphas.shape[0]):
        k = k + torch.exp(-alphas[i] * d2)
    return k


def _stat_from_indicators(k: torch.Tensor, a: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Unbiased MMD statistic(s) for (p, m) indicator rows ``a``; (p,)."""
    b = 1.0 - a
    diag = torch.diagonal(k)
    diag_total = torch.sum(diag)
    a_diag = a @ diag
    ak = a @ k
    s_xx_full = torch.sum(ak * a, dim=-1)
    s_xy = torch.sum(ak * b, dim=-1)
    s_yy_full = torch.sum(k) - s_xx_full - 2.0 * s_xy
    s_xx = s_xx_full - a_diag
    s_yy = s_yy_full - (diag_total - a_diag)
    return (
        s_xx / (n1 * (n1 - 1))
        + s_yy / (n2 * (n2 - 1))
        - 2.0 * s_xy / (n1 * n2)
    )


def _indicators(n1: int, n2: int, n_permutations: int, generator, dtype, device):
    """(P, m) 0/1 rows, each a uniform permutation of n1 ones and n2 zeros."""
    base = torch.cat([torch.ones(n1, dtype=dtype), torch.zeros(n2, dtype=dtype)]).to(device)
    keys = torch.rand((n_permutations, n1 + n2), generator=generator, device=device)
    return base[torch.argsort(keys, dim=1)]


def _pooled(x, y, device):
    """Stack the samples on ``device`` (:func:`resolve_device`: the card by
    default). Tensors given with ``device=None`` stay where they are."""
    n1, n2 = len(x), len(y)
    if device is not None or not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
        device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    return torch.cat([x, y], dim=0), n1, n2


def mmd_permutation_test_sweep(
    x,
    y,
    alphas: Sequence[float],
    generator: Optional[torch.Generator] = None,
    n_permutations: int = 1000,
    permutations: Optional[torch.Tensor] = None,
    device=None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-alpha tests for each alpha, sharing the distances and the
    permutation set. Returns ``(statistics, p_values)``, each (len(alphas),).
    Working precision is the inputs' (float32 on the estimator path:
    screening only, see :func:`mmd_permutation_test_sweep_precise`). Past
    ``DENSE_GOF_MAX_M`` pooled samples the K5 kernel computes the test in
    float32, with its permutation rows sharded over the 'data' ranks of a
    ``mesh`` when one is given."""
    if len(x) + len(y) > DENSE_GOF_MAX_M:
        from vgan_tpu_torch.ops.cuda import gof_gram

        return gof_gram.mmd_permutation_test_tiled_sweep(
            x, y, alphas, generator=generator, n_permutations=n_permutations,
            permutations=permutations, mesh=mesh, device=device)
    z, n1, n2 = _pooled(x, y, device)
    d2 = pairwise_sq_dists(z)
    base = torch.cat([torch.ones(n1, dtype=z.dtype), torch.zeros(n2, dtype=z.dtype)]).to(z.device)
    if permutations is None:
        permutations = _indicators(n1, n2, n_permutations, generator, z.dtype, z.device)
    perms = torch.as_tensor(permutations, dtype=z.dtype, device=z.device)
    stats, pvals = [], []
    for alpha in alphas:
        k = torch.exp(-float(alpha) * d2)
        observed = _stat_from_indicators(k, base[None, :], n1, n2)[0]
        perm_stats = _stat_from_indicators(k, perms, n1, n2)
        stats.append(observed)
        pvals.append(torch.mean((perm_stats >= observed).to(z.dtype)))
    return torch.stack(stats), torch.stack(pvals)


def mmd_permutation_test(
    x,
    y,
    alphas: Sequence[float],
    generator: Optional[torch.Generator] = None,
    n_permutations: int = 1000,
    permutations: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One test on the summed-alpha kernel; ``(statistic, p_value)``. Past
    ``DENSE_GOF_MAX_M`` pooled samples through the K5 kernel."""
    if len(x) + len(y) > DENSE_GOF_MAX_M:
        from vgan_tpu_torch.ops.cuda import gof_gram

        return gof_gram.mmd_permutation_test_tiled(
            x, y, alphas, generator=generator, n_permutations=n_permutations,
            permutations=permutations, device=device)
    z, n1, n2 = _pooled(x, y, device)
    k = alpha_gram(z, torch.tensor([float(a) for a in alphas], dtype=z.dtype, device=z.device))
    base = torch.cat([torch.ones(n1, dtype=z.dtype), torch.zeros(n2, dtype=z.dtype)]).to(z.device)
    observed = _stat_from_indicators(k, base[None, :], n1, n2)[0]
    if permutations is None:
        permutations = _indicators(n1, n2, n_permutations, generator, z.dtype, z.device)
    perms = torch.as_tensor(permutations, dtype=z.dtype, device=z.device)
    perm_stats = _stat_from_indicators(k, perms, n1, n2)
    return observed, torch.mean((perm_stats >= observed).to(z.dtype))


def _stats_from_indicators_np(k, a, n1: int, n2: int):
    """float64 numpy twin of :func:`_stat_from_indicators`."""
    b = 1.0 - a
    diag = np.diagonal(k)
    a_diag = a @ diag
    ak = a @ k
    s_xx_full = np.einsum("pm,pm->p", ak, a)
    s_xy = np.einsum("pm,pm->p", ak, b)
    s_yy_full = k.sum() - s_xx_full - 2.0 * s_xy
    s_xx = s_xx_full - a_diag
    s_yy = s_yy_full - (diag.sum() - a_diag)
    return (
        s_xx / (n1 * (n1 - 1))
        + s_yy / (n2 * (n2 - 1))
        - 2.0 * s_xy / (n1 * n2)
    )


def mmd_permutation_test_sweep_precise(
    x,
    y,
    alphas: Sequence[float],
    rng=None,
    n_permutations: int = 1000,
    permutations=None,
    device=None,
    mesh=None,
):
    """float64 sweep, the precise path for null-regime p-values.

    Under the null the statistic (~1e-7) sits below the rounding noise of an
    f32 accumulation of the O(m^2) Gram sums, so kernels and sums are
    computed in float64 numpy. Past ``DENSE_PRECISE_MAX_M`` pooled samples
    the K5 kernel computes Kahan-compensated float32 C planes on ``device``
    (:func:`resolve_device`: the card unless told otherwise) and the
    quadratic forms are reduced in float64 on the host (the permutation rows
    sharded over the 'data' ranks of ``mesh``, when given). ``rng`` is a
    ``numpy.random.Generator`` that draws the permutations on both routes;
    ``permutations`` an optional pre-drawn (P, m) 0/1 matrix (rows sum to
    n1). Returns numpy ``(statistics, p_values)``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n1, n2 = x.shape[0], y.shape[0]
    if permutations is None:
        rng = rng if rng is not None else np.random.default_rng(0)
        base = np.concatenate([np.ones(n1), np.zeros(n2)])
        permutations = np.stack(
            [rng.permutation(base) for _ in range(n_permutations)]
        )
    if n1 + n2 > DENSE_PRECISE_MAX_M:
        from vgan_tpu_torch.ops.cuda import gof_gram

        stats, pvals = gof_gram.mmd_permutation_test_tiled_sweep(
            x.astype(np.float32), y.astype(np.float32), alphas, precision="float64",
            permutations=permutations, mesh=mesh, device=resolve_device(device))
        return stats.numpy(), pvals.numpy()
    z = np.concatenate([x, y], axis=0)
    zn = np.sum(z * z, axis=1)
    d2 = np.maximum(zn[:, None] + zn[None, :] - 2.0 * (z @ z.T), 0.0)
    base_row = np.concatenate([np.ones((1, n1)), np.zeros((1, n2))], axis=1)

    stats, pvals = [], []
    for alpha in alphas:
        k = np.exp(-float(alpha) * d2)
        observed = _stats_from_indicators_np(k, base_row, n1, n2)[0]
        perm_stats = _stats_from_indicators_np(k, permutations, n1, n2)
        stats.append(observed)
        pvals.append(float(np.mean(perm_stats >= observed)))
    return np.asarray(stats), np.asarray(pvals)
