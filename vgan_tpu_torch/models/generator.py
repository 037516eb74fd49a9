"""Subspace generator MLPs (counterpart of ``vgan_tpu.models.generator``).

``GeneratorBig`` maps latent noise z (L,) through a purely linear MLP
L -> 2L -> 4L -> 8L -> d (no nonlinearities between the layers, as in the
reference) terminated by the upper-softmax activation. Its parameters are
``main.{0..3}.{weight, bias}`` with torch's (out, in) weights, the layout of
the reference's saved ``generator_*.pt``, so such a file loads as it is.
The latent size the estimators use is ``L = max(d // 16, 1)``.

``Generator`` is the square L -> L x4 variant the reference defines but
never instantiates.

``compute_dtype=torch.bfloat16`` is the JAX package's ``model_matmul_dtype``
(Flax ``Dense(dtype=bf16)``): see :func:`linear_stack`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vgan_tpu_torch.models.initializers import REFERENCE_NORMAL, init_linear_
from vgan_tpu_torch.ops.activations import (
    gumbel_upper_softmax,
    st_upper_softmax,
    upper_softmax,
)

ACTIVATIONS = ("upper_softmax", "st", "gumbel_st")


def linear_stack(main: nn.Sequential, h: torch.Tensor,
                 compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The linear layers of ``main`` on ``h``. With ``compute_dtype``, as Flax
    ``Dense(dtype=compute_dtype)``: each layer rounds its input, weight and
    bias to it, multiplies in float32 (products of bf16 values are exact
    there, and the sum is float32, as XLA accumulates; no global cuBLAS flag
    is read), rounds the product once and adds the bias in the compute
    dtype (a second rounding); the last layer's output is cast to float32.
    The parameters keep their own dtype. The gradients round where JAX's
    do: each layer's input and weight cotangents to the compute dtype."""
    if compute_dtype is None:
        return main(h)
    for layer in main:
        w = layer.weight.to(compute_dtype).float()
        h = F.linear(h.to(compute_dtype).float(), w).to(compute_dtype)
        h = h + layer.bias.to(compute_dtype)
    return h.float()


def _linear(fan_in: int, fan_out: int, scheme: str, generator, dtype) -> nn.Linear:
    layer = nn.utils.skip_init(nn.Linear, fan_in, fan_out, dtype=dtype)
    init_linear_(layer, scheme, generator)
    return layer


class GeneratorBig(nn.Module):
    """Latent L -> 2L -> 4L -> 8L -> d linear MLP + upper-softmax.

    Built on the CPU from ``generator`` (a seeded ``torch.Generator``; a
    fresh unseeded one when None) so the weights do not depend on the
    device; move it with ``.to(device)``. ``activation`` selects the
    gradient estimator of the terminal binarization: 'upper_softmax'
    (reference), 'st' or 'gumbel_st' (which takes ``gumbel`` noise).
    ``compute_dtype``: see :func:`linear_stack` (training and sampling both).
    """

    def __init__(
        self,
        out_features: int,
        latent_size: int,
        init_scheme: str = REFERENCE_NORMAL,
        activation: str = "upper_softmax",
        gumbel_tau: float = 1.0,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        generator = generator if generator is not None else torch.Generator()
        widths = [2 * latent_size, 4 * latent_size, 8 * latent_size, out_features]
        layers, fan_in = [], latent_size
        for w in widths:
            layers.append(_linear(fan_in, w, init_scheme, generator, dtype))
            fan_in = w
        self.main = nn.Sequential(*layers)
        self.out_features = out_features
        self.latent_size = latent_size
        self.activation = activation
        self.gumbel_tau = gumbel_tau
        self.compute_dtype = compute_dtype

    def forward(self, z: torch.Tensor, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = linear_stack(self.main, z, self.compute_dtype)
        if self.activation == "upper_softmax":
            return upper_softmax(h, axis=-1)
        if self.activation == "st":
            return st_upper_softmax(h, axis=-1)
        if gumbel is None:
            raise ValueError(
                "activation='gumbel_st' requires Gumbel noise; inference paths "
                "use the deterministic upper_softmax"
            )
        return gumbel_upper_softmax(h, gumbel, tau=self.gumbel_tau, axis=-1)

    def sample(self, z: torch.Tensor) -> torch.Tensor:
        """The deterministic upper-softmax forward, whatever ``activation``."""
        return upper_softmax(linear_stack(self.main, z, self.compute_dtype), axis=-1)


class Generator(nn.Module):
    """Square latent L -> L x4 linear MLP + upper-softmax (unused variant)."""

    def __init__(
        self,
        latent_size: int,
        init_scheme: str = REFERENCE_NORMAL,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        generator = generator if generator is not None else torch.Generator()
        self.main = nn.Sequential(
            *[_linear(latent_size, latent_size, init_scheme, generator, dtype) for _ in range(4)]
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return upper_softmax(self.main(z), axis=-1)


def latent_size_for(ndims: int) -> int:
    """Reference latent-size rule: ``max(d // 16, 1)``."""
    return max(int(ndims / 16), 1)
