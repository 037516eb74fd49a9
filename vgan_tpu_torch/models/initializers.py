"""Weight initializers of the reference's two init regimes.

- ``reference_normal``: W ~ N(0, 0.1), b = 0, the hook the kernel-learning
  ``VGAN.fit`` applies to every Linear layer.
- ``torch_default``: PyTorch's stock ``nn.Linear`` bound, W and b both
  ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)); ``VGAN_no_kl`` trains from it.

Both draw from an explicit ``torch.Generator``, never the global RNG.
"""

from __future__ import annotations

import math

import torch
from torch import nn

REFERENCE_NORMAL = "reference_normal"
TORCH_DEFAULT = "torch_default"


@torch.no_grad()
def init_linear_(layer: nn.Linear, scheme: str, generator: torch.Generator) -> None:
    """Initialize ``layer`` in place under ``scheme``."""
    fan_in = layer.in_features
    if scheme == REFERENCE_NORMAL:
        layer.weight.normal_(0.0, 0.1, generator=generator)
        layer.bias.zero_()
    elif scheme == TORCH_DEFAULT:
        bound = 1.0 / math.sqrt(fan_in)
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    else:
        raise ValueError(f"unknown init scheme: {scheme!r}")
