"""Adversarial detector of the kl variant (counterpart of
``vgan_tpu.models.detector``).

``Encoder`` maps d -> 8L -> 4L -> 2L -> L and ``Decoder`` maps back
L -> 2L -> 4L -> 8L -> d; both are purely linear, as in the reference.
``Detector`` returns ``(encode(x), decode(encode(x)))``: the encoding feeds
the MMD (the learned kernel's embedding), the decoding the reconstruction
penalties of the detector loss.

Parameters are ``encoder.main.{0..3}.{weight, bias}`` and
``decoder.main.{0..3}.{weight, bias}`` with torch's (out, in) weights, the
layout of the reference's ``Detector`` state dict.

``compute_dtype`` (the JAX package's ``model_matmul_dtype``) runs each of
the two stacks through :func:`~vgan_tpu_torch.models.generator.linear_stack`:
the encoding and the reconstruction come out in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vgan_tpu_torch.models.generator import _linear, linear_stack
from vgan_tpu_torch.models.initializers import REFERENCE_NORMAL


def _stack(widths: Sequence[int], scheme: str, generator, dtype) -> nn.Sequential:
    return nn.Sequential(*[
        _linear(fan_in, fan_out, scheme, generator, dtype)
        for fan_in, fan_out in zip(widths[:-1], widths[1:])
    ])


class Encoder(nn.Module):
    """d -> 8L -> 4L -> 2L -> L, purely linear."""

    def __init__(self, latent_size: int, in_features: int, init_scheme: str = REFERENCE_NORMAL,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator()
        self.compute_dtype = compute_dtype
        L = latent_size
        self.main = _stack([in_features, 8 * L, 4 * L, 2 * L, L], init_scheme, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_stack(self.main, x, self.compute_dtype)


class Decoder(nn.Module):
    """L -> 2L -> 4L -> 8L -> d, purely linear."""

    def __init__(self, latent_size: int, out_features: int, init_scheme: str = REFERENCE_NORMAL,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator()
        self.compute_dtype = compute_dtype
        L = latent_size
        self.main = _stack([L, 2 * L, 4 * L, 8 * L, out_features], init_scheme, generator, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return linear_stack(self.main, h, self.compute_dtype)


class Detector(nn.Module):
    """Encoder/decoder pair; ``forward`` returns ``(encoding, reconstruction)``.

    Built on the CPU from ``generator`` (encoder layers first, then the
    decoder's), so the weights do not depend on the device.
    """

    def __init__(self, latent_size: int, in_features: int, init_scheme: str = REFERENCE_NORMAL,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator()
        self.encoder = Encoder(latent_size, in_features, init_scheme, dtype, generator,
                               compute_dtype)
        self.decoder = Decoder(latent_size, in_features, init_scheme, dtype, generator,
                               compute_dtype)

    def forward(self, x: torch.Tensor):
        enc = self.encoder(x)
        return enc, self.decoder(enc)
