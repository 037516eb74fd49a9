"""The inputs of every cell, made on the device from the run's seed: the
same seed gives the same inputs, and the program and the reference are
handed the same tensors. One ``torch.Generator`` on the device draws, in
this order, the dataset, the test batches and the masks."""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**64))


def dataset(config: dict, seed: int, device, g=None) -> torch.Tensor:
    """The configuration's (n, d) float32 rows: standard normal."""
    g = g if g is not None else generator(seed, device)
    return torch.randn((config["n"], config["d"]), generator=g, device=device,
                       dtype=torch.float32)


def score_inputs(config: dict, traffic: dict, seed: int, device):
    """``(x_train, x_test, masks)``: the configuration's rows, (batches,
    n_test, d) test rows whose first ``outlier_share`` of each batch are
    scaled by ``outlier_scale``, and (n_masks, d) bool masks keeping each
    column with ``keep_probability`` (a mask that keeps none keeps column 0)."""
    g = generator(seed, device)
    x_train = dataset(config, seed, device, g)
    nb, nt, d = traffic["test_batches"], traffic["n_test"], config["d"]
    x_test = torch.randn((nb, nt, d), generator=g, device=device, dtype=torch.float32)
    n_out = int(round(traffic["outlier_share"] * nt))
    x_test[:, :n_out] *= traffic["outlier_scale"]
    masks = torch.rand((traffic["n_masks"], d), generator=g, device=device) < traffic[
        "keep_probability"]
    masks[~masks.any(dim=1), 0] = True
    return x_train, x_test, masks
