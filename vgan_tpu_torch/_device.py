"""Device resolution: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` when ``device`` is None; raises when there is no card.

    The CPU is used only when the caller asks for it (``device="cpu"``), as
    the tests do; there is no silent fallback.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vgan_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
