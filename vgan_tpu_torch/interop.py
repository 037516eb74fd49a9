"""Carry state over from the JAX package's layout, as numpy arrays.

A Flax ``GeneratorBig`` holds ``{"params": {"Dense_i": {"kernel": (in, out),
"bias": (out,)}}}``; the port's generator (and the reference's saved
``generator_*.pt``) holds ``main.{i}.weight`` (out, in) and ``main.{i}.bias``.
A Flax ``Detector`` holds the same per-layer trees under ``"encoder"`` and
``"decoder"``; the port's holds ``{encoder, decoder}.main.{i}.{weight,
bias}``. The same mappings carry the Adadelta state (``square_avg``,
``acc_delta``), so a test can start both implementations from one state; a
bf16 leaf (``ml_dtypes``' bfloat16 numpy dtype, as ``np.asarray`` gives a JAX
bf16 array) becomes a torch bf16 tensor of the same values. Only numpy
crosses this boundary: the port never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vgan_tpu_torch._dtypes import low_precision
from vgan_tpu_torch.train.adadelta import AdadeltaState


def _tensor(a) -> torch.Tensor:
    """A numpy array as a C-contiguous tensor; bf16 leaves stay bf16 (through
    float32, which holds every bf16 value exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def generator_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dict of numpy arrays, with or without
    the outer ``"params"`` level) -> ``main.{i}.{weight, bias}`` tensors."""
    tree = params_np.get("params", params_np)
    layers = sorted(tree, key=lambda k: int(k.split("_")[1]))
    out = {}
    for i, name in enumerate(layers):
        out[f"main.{i}.weight"] = _tensor(np.asarray(tree[name]["kernel"]).T)
        out[f"main.{i}.bias"] = _tensor(tree[name]["bias"])
    return out


def detector_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax detector params ``{"params": {"encoder": {"Dense_i": ...},
    "decoder": {...}}}`` -> ``{encoder, decoder}.main.{i}.{weight, bias}``."""
    tree = params_np.get("params", params_np)
    return {
        f"{part}.{k}": v
        for part in ("encoder", "decoder")
        for k, v in generator_state_dict_from_jax(tree[part]).items()
    }


def state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A generator's or a detector's Flax params -> the port's state dict."""
    tree = params_np.get("params", params_np)
    if "encoder" in tree:
        return detector_state_dict_from_jax(tree)
    return generator_state_dict_from_jax(tree)


def adadelta_state_from_jax(square_avg_np, acc_delta_np, device=None,
                            state_dtype=None) -> AdadeltaState:
    """The JAX ``AdadeltaState`` leaves (params-shaped trees of a generator
    or a detector) -> the port's. ``state_dtype='bfloat16'`` stores them in
    bf16 (for leaves that reached numpy as float32); bf16 leaves stay bf16."""
    dtype = low_precision(state_dtype, "state_dtype")

    def conv(tree):
        return {k: v.to(device=device, dtype=dtype or v.dtype)
                for k, v in state_dict_from_jax(tree).items()}

    return AdadeltaState(conv(square_avg_np), conv(acc_delta_np))
