"""The precisions a reference runs in: 'float64' (the reference itself),
'float32', and 'tf32' (float32 whose matrix products, forward and backward,
take operands rounded to TF32's 10-bit mantissa: the step below float32
with TF32 off, the control that the comparison must refuse). The rounding
is done explicitly, so the control reads the same on a card and on a CPU."""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: expected one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest on a 10-bit mantissa (ties away)."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.T, ra.T @ rg


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision`` (TF32 off for the two IEEE precisions)."""
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b
