"""Multi-bandwidth RBF kernel and constrained squared-MMD loss (plain torch).

Counterpart of ``vgan_tpu.ops.mmd``:

- 5 RBF kernels with bandwidth multipliers ``2^(k-2)`` = {1/4, 1/2, 1, 2, 4};
- data-driven bandwidth ``sum_ij d2_ij / (m^2 - m)`` through the centered
  closed form, detached from autograd;
- biased (V-statistic) squared MMD ``K_XX.mean() - 2 K_XY.mean() +
  K_YY.mean()`` on the stacked Gram;
- coverage penalty ``mean_j(1 - max_i U[i, j])``.

The bandwidth is explicit state ``(bw_value, bw_is_set)`` threaded by the
caller. ``impl`` selects the implementation: 'torch' materializes the Gram,
'cuda' runs the hand-written kernels (``vgan_tpu_torch.ops.cuda.mmd_gram``),
'chunked' reduces row blocks under ``torch.utils.checkpoint``, and 'auto'
picks the kernels for CUDA tensors with d >= 512 or m >= 4096 (the JAX
package's ``pallas_supported`` rule) and escapes to 'chunked' past
``_DENSE_MAX_M`` samples otherwise.

``matmul_dtype='bfloat16'`` (the JAX package's ``gram_matmul_dtype``) rounds
the operands of the distance product ``<x_i, y_j>`` to bf16 on every path;
the norms come from the unrounded rows (so a row's distance to itself is
not 0 before the clamp) and the ladder stays in the input's dtype. The
product is taken in float32 on the rounded values, whose products are exact
there, so only the summation order differs from JAX's bf16 dot with float32
accumulation; the CUDA path runs the kernels' bf16-operand variants.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vgan_tpu_torch._dtypes import low_precision
from vgan_tpu_torch.utils.profiling import annotate

DEFAULT_N_KERNELS = 5
DEFAULT_MUL_FACTOR = 2.0

# Above this sample count the dense path's (m, m) Gram is too large to
# materialize; impl='auto' routes to the row-blocked chunked path instead.
_DENSE_MAX_M = 16384

IMPLS = ("torch", "auto", "cuda", "chunked")




def bandwidth_multipliers(
    n_kernels: int = DEFAULT_N_KERNELS,
    mul_factor: float = DEFAULT_MUL_FACTOR,
) -> Tuple[float, ...]:
    """Static tuple of bandwidth multipliers ``mul_factor ** (k - n//2)``."""
    return tuple(float(mul_factor) ** (k - n_kernels // 2) for k in range(n_kernels))


def pairwise_sq_dists(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    matmul_dtype: Optional[str] = None,
) -> torch.Tensor:
    """``d2[i, j] = |x_i|^2 + |y_j|^2 - 2 <x_i, y_j>``, clamped at 0; with
    ``matmul_dtype`` the cross product is float32 on the rounded rows, cast
    to x's dtype, and the norms are the unrounded rows'."""
    if y is None:
        y = x
    xn = torch.sum(x * x, dim=-1)
    yn = torch.sum(y * y, dim=-1)
    md = low_precision(matmul_dtype, "matmul_dtype")
    if md is None:
        cross = x @ y.T
    else:
        cross = (x.to(md).float() @ y.to(md).float().T).to(x.dtype)
    d2 = xn[:, None] + yn[None, :] - 2.0 * cross
    return torch.clamp_min(d2, 0.0)


def reference_bandwidth(d2: torch.Tensor) -> torch.Tensor:
    """Reference bandwidth rule ``sum(d2) / (m^2 - m)``, detached."""
    m = d2.shape[0]
    return (torch.sum(d2) / (m * m - m)).detach()


def candidate_bandwidth(z: torch.Tensor) -> torch.Tensor:
    """``sum_ij |z_i - z_j|^2 / (m^2 - m)`` through the centered closed form
    ``2 m sum_i |z_i - mean(z)|^2``; shared by every impl, detached."""
    m = z.shape[0]
    zc = z - torch.mean(z, dim=0, keepdim=True)
    total = 2.0 * m * torch.sum(zc * zc)
    return (total / (m * m - m)).detach()


def ladder_exponents(mults: Tuple[float, ...]):
    """``(base_mult, ints)`` with ``exp(-d2/(bw mk)) = t^ints[k]`` for
    ``t = exp(-d2/(bw base_mult))``, or None when the ladder is not
    integer-structured."""
    base = max(mults)
    ints = []
    for mk in mults:
        r = base / mk
        i = int(round(r))
        if abs(r - i) > 1e-9 or i > 64:
            return None
        ints.append(i)
    return base, tuple(ints)


def integer_powers(t: torch.Tensor, ints: Tuple[int, ...]):
    """``[t**i for i in ints]`` via a shared square-and-multiply chain."""
    cache = {1: t}

    def power(i: int) -> torch.Tensor:
        if i in cache:
            return cache[i]
        half = power(i // 2)
        r = half * half
        if i % 2:
            r = r * t
        cache[i] = r
        return r

    return [power(i) for i in ints]


def multi_rbf_gram(
    d2: torch.Tensor,
    bandwidth: torch.Tensor,
    mults: Tuple[float, ...] = bandwidth_multipliers(),
) -> torch.Tensor:
    """``K = sum_k exp(-d2 / (bandwidth * mults[k]))``; one exp plus integer
    powers for a geometric ladder."""
    ladder = ladder_exponents(mults)
    k = torch.zeros_like(d2)
    if ladder is not None:
        base, ints = ladder
        t = torch.exp(-d2 / (bandwidth * base))
        for p in integer_powers(t, ints):
            k = k + p
        return k
    for mk in mults:
        k = k + torch.exp(-d2 / (bandwidth * mk))
    return k


def _frozen(bandwidth, like: torch.Tensor):
    if bandwidth is None:
        return (
            torch.zeros((), dtype=like.dtype, device=like.device),
            torch.zeros((), dtype=torch.bool, device=like.device),
        )
    return (
        torch.as_tensor(bandwidth, dtype=like.dtype, device=like.device),
        torch.ones((), dtype=torch.bool, device=like.device),
    )


def mmd2_biased(
    x: torch.Tensor,
    y: torch.Tensor,
    bandwidth=None,
    mults: Tuple[float, ...] = bandwidth_multipliers(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased squared MMD; returns ``(mmd2, bandwidth_used)``."""
    bw_value, bw_is_set = _frozen(bandwidth, x)
    return mmd2_biased_stateful(x, y, bw_value, bw_is_set, mults)


def coverage_penalty(u: torch.Tensor) -> torch.Tensor:
    """``mean_j(1 - max_i U[i, j])``. ``torch.amax`` splits the gradient
    evenly among tied maxima, as ``jnp.max`` does."""
    return torch.mean(1.0 - torch.amax(u, dim=0))


@annotate("vgan::mmd.forward")
def mmd2_biased_stateful(
    x: torch.Tensor,
    y: torch.Tensor,
    bw_value: torch.Tensor,
    bw_is_set: torch.Tensor,
    mults: Tuple[float, ...] = bandwidth_multipliers(),
    impl: str = "torch",
    matmul_dtype: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased MMD^2 with threaded bandwidth state: the candidate bandwidth of
    this batch is used while ``bw_is_set`` is False, ``bw_value`` after.
    Returns ``(mmd2, bandwidth_used)``; no host sync."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl={impl!r}: expected one of {IMPLS}")
    low_precision(matmul_dtype, "matmul_dtype")
    if impl == "chunked":
        return mmd2_biased_chunked(x, y, bw_value, bw_is_set, mults, matmul_dtype=matmul_dtype)
    if impl != "torch":
        from vgan_tpu_torch.ops.cuda.mmd_gram import (
            cuda_supported,
            mmd2_biased_stateful_cuda,
        )

        m = x.shape[0] + y.shape[0]
        if impl == "cuda" or (impl == "auto" and cuda_supported(x, y)):
            return mmd2_biased_stateful_cuda(x, y, bw_value, bw_is_set, mults, matmul_dtype)
        if impl == "auto" and m > _DENSE_MAX_M:
            return mmd2_biased_chunked(x, y, bw_value, bw_is_set, mults,
                                       matmul_dtype=matmul_dtype)
    n1 = x.shape[0]
    z = torch.cat([x, y], dim=0)
    d2 = pairwise_sq_dists(z, matmul_dtype=matmul_dtype)
    candidate = candidate_bandwidth(z)
    bw = torch.where(bw_is_set, bw_value, candidate)
    k = multi_rbf_gram(d2, bw, mults)
    kxx = torch.mean(k[:n1, :n1])
    kxy = torch.mean(k[:n1, n1:])
    kyy = torch.mean(k[n1:, n1:])
    return kxx - 2.0 * kxy + kyy, bw


def mmd2_biased_chunked(
    x: torch.Tensor,
    y: torch.Tensor,
    bw_value: torch.Tensor,
    bw_is_set: torch.Tensor,
    mults: Tuple[float, ...] = bandwidth_multipliers(),
    row_block: int = 2048,
    matmul_dtype: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbounded-m biased MMD^2: row-blocked quadrant sums with O(block x m)
    memory; each block is recomputed in the backward
    (``torch.utils.checkpoint``) instead of saved. ``matmul_dtype`` rounds
    the blocks' product operands (products in z's dtype). The row blocks and
    the columns read two rounded copies of z, as JAX's ``z_pad_dot`` and
    ``z_dot``: each copy's cotangent is summed over the blocks in the matmul
    dtype, as JAX's are."""
    n1, n2 = x.shape[0], y.shape[0]
    m = n1 + n2
    z = torch.cat([x, y], dim=0)
    candidate = candidate_bandwidth(z)
    bw = torch.where(bw_is_set, bw_value, candidate).to(z.dtype)
    zn = torch.sum(z * z, dim=-1)
    md = low_precision(matmul_dtype, "matmul_dtype")
    z_rows_dot, z_cols_dot = (z, z) if md is None else (z.to(md), z.to(md))
    col_x = torch.arange(m, device=z.device) < n1

    def block_sums(rows, rows_dot, start: int):
        rn = torch.sum(rows * rows, dim=-1)
        cross = rows_dot.to(z.dtype) @ z_cols_dot.to(z.dtype).T
        d2 = torch.clamp_min(rn[:, None] + zn[None, :] - 2.0 * cross, 0.0)
        k = multi_rbf_gram(d2, bw, mults)
        row_x = (start + torch.arange(rows.shape[0], device=z.device)) < n1
        sxx = torch.sum(torch.where(row_x[:, None] & col_x[None, :], k, 0.0))
        sxy = torch.sum(torch.where(row_x[:, None] & ~col_x[None, :], k, 0.0))
        syy = torch.sum(torch.where(~row_x[:, None] & ~col_x[None, :], k, 0.0))
        return torch.stack([sxx, sxy, syy])

    total = torch.zeros(3, dtype=z.dtype, device=z.device)
    for start in range(0, m, row_block):
        block = slice(start, start + row_block)
        total = total + checkpoint(block_sums, z[block], z_rows_dot[block], start,
                                   use_reentrant=False)
    mmd2 = (
        total[0] / (n1 * n1) - 2.0 * total[1] / (n1 * n2) + total[2] / (n2 * n2)
    )
    return mmd2, bw


def mmd_loss_constrained_stateful(
    x: torch.Tensor,
    y: torch.Tensor,
    u: torch.Tensor,
    weight: float,
    bw_value: torch.Tensor,
    bw_is_set: torch.Tensor,
    mults: Tuple[float, ...] = bandwidth_multipliers(),
    impl: str = "torch",
    matmul_dtype: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stateful-bandwidth constrained MMD loss; returns ``(loss, bw_used)``."""
    mmd2, bw = mmd2_biased_stateful(
        x, y, bw_value, bw_is_set, mults, impl, matmul_dtype
    )
    return mmd2 + weight * coverage_penalty(u), bw


def mmd_loss_constrained(
    x: torch.Tensor,
    y: torch.Tensor,
    u: torch.Tensor,
    weight: float,
    bandwidth=None,
    mults: Tuple[float, ...] = bandwidth_multipliers(),
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased MMD^2 + ``weight`` * coverage penalty; ``(loss, bw_used)``."""
    bw_value, bw_is_set = _frozen(bandwidth, x)
    return mmd_loss_constrained_stateful(
        x, y, u, weight, bw_value, bw_is_set, mults, impl
    )
