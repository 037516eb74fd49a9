"""Subspace-selection activations (counterpart of ``vgan_tpu.ops.activations``).

The generator's terminal activation maps logits to a "soft-binary" row:
coordinates whose softmax mass reaches the uniform level 1/d snap to exactly
1.0; the rest keep their softmax value. The selection mask is a constant in
the gradient (``torch.where`` with a constant branch): snapped coordinates
contribute zero local gradient. This is not a straight-through estimator;
:func:`st_upper_softmax` and :func:`gumbel_upper_softmax` are the opt-in
straight-through variants.
"""

from __future__ import annotations

import torch


def _one(s: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=s.dtype, device=s.device)


def upper_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax with upper snapping: values >= 1/d become exactly 1.0."""
    d = x.shape[axis]
    s = torch.softmax(x, dim=axis)
    return torch.where(s >= 1.0 / d, _one(s), s)


def upper_lower_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Selected coordinates keep their softmax value, the others become 1e-8."""
    d = x.shape[axis]
    s = torch.softmax(x, dim=axis)
    return torch.where(s >= 1.0 / d, s, torch.full((), 1e-8, dtype=s.dtype, device=s.device))


def binarize_mask(u: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Hard subspace mask ``u >= 1/d`` (bool)."""
    d = u.shape[axis]
    return u >= 1.0 / d


def st_upper_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Forward of :func:`upper_softmax`, gradient of the plain softmax."""
    d = x.shape[axis]
    s = torch.softmax(x, dim=axis)
    forward = torch.where(s >= 1.0 / d, _one(s), s)
    return (forward - s).detach() + s


def gumbel_upper_softmax(
    x: torch.Tensor,
    gumbel: torch.Tensor,
    tau: float = 1.0,
    axis: int = -1,
    hard: bool = True,
) -> torch.Tensor:
    """Gumbel-softmax relaxation of the upper-softmax selection.

    ``gumbel`` is the standard Gumbel noise of ``x``'s shape, drawn by the
    caller (so tests can inject another framework's draw).
    """
    s = torch.softmax((x + gumbel) / tau, dim=axis)
    if not hard:
        return s
    d = x.shape[axis]
    forward = torch.where(s >= 1.0 / d, _one(s), s)
    return (forward - s).detach() + s


def sample_gumbel(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` from a seeded generator."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = torch.clamp_min(u, torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))
