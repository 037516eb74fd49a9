"""Subspace-aware isolation forest (counterpart of ``vgan_tpu.ensemble.iforest``).

The iForest algorithm (Liu et al. 2008) with static shapes, in two parts:

- :func:`draw_iforest` draws the randomness once, from one seeded CPU
  ``torch.Generator``: each tree's subsample of ``psi`` train rows, and per
  node a uniform that picks its split feature and a uniform that places its
  threshold. The draws are then moved to the device, so one seed grows the
  same trees on the CPU and on the card. As in the JAX package (one fixed key
  for every mask), the draws are shared by every subspace mask, and each mask
  picks its own split features from them.
- :func:`iforest_from_draws` builds and scores the forests of a chunk of
  masks from those draws, deterministically. A tree is ``depth =
  ceil(log2(psi))`` levels. At each level every subsampled point carries its
  node id; each node splits on its feature at ``min + u (max - min)`` of the
  node's values of that feature (0 for an empty node, exactly as the JAX
  package computes it), and ids advance ``2 id + (v > t)``. Scoring descends
  the same levels; a point stops at the first node that held at most one
  training point, with the ``c(size)`` correction at the depth cap, and
  ``score = 2 ** (-E_trees[h(x)] / c(psi))``: higher is more anomalous.

Node tables are read with index gathers (the JAX package's one-hot matmuls
exist to avoid gathers on the TPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device

DEFAULT_PSI = 256
_EULER = 0.5772156649


class IForestDraws(NamedTuple):
    """The random draws of a forest, shared by every mask.

    ``subsample`` (n_trees, psi) int64 train rows of each tree;
    ``feature_u`` and ``threshold_u`` (n_trees, 2**depth - 1) float32
    uniforms in [0, 1), one per node, level by level (level l's nodes at
    ``2**l - 1 .. 2**(l+1) - 2``)."""

    subsample: torch.Tensor
    feature_u: torch.Tensor
    threshold_u: torch.Tensor

    def to(self, device) -> "IForestDraws":
        return IForestDraws(*(t.to(device) for t in self))


def forest_shape(n_train: int, psi: int = DEFAULT_PSI):
    """``(psi, depth)``: the subsample size clamped to n_train, and the
    number of levels, ``ceil(log2(psi))`` and at least 1."""
    psi = min(int(psi), int(n_train))
    return psi, max(1, math.ceil(math.log2(psi)))


def _c_factor(s: torch.Tensor) -> torch.Tensor:
    """Average unsuccessful-BST-search path length c(s); c(s <= 1) = 0."""
    big = 2.0 * (torch.log(torch.clamp_min(s - 1.0, 1.0)) + _EULER) - 2.0 * (
        torch.clamp_min(s - 1.0, 0.0) / torch.clamp_min(s, 1.0)
    )
    return torch.where(s > 2.0, big, (s == 2.0).to(s.dtype))


def draw_iforest(n_train: int, n_trees: int, psi: int = DEFAULT_PSI,
                 seed: int = 0) -> IForestDraws:
    """The forest's draws on the CPU, from a CPU generator seeded with
    ``seed``: each tree's ``psi`` distinct train rows, then the per-node
    feature and threshold uniforms."""
    g = torch.Generator().manual_seed(int(seed))
    psi, depth = forest_shape(n_train, psi)
    sub = torch.stack([torch.randperm(int(n_train), generator=g)[:psi] for _ in range(n_trees)])
    n_nodes = 2**depth - 1
    feature_u = torch.rand((n_trees, n_nodes), generator=g, dtype=torch.float32)
    threshold_u = torch.rand((n_trees, n_nodes), generator=g, dtype=torch.float32)
    return IForestDraws(sub, feature_u, threshold_u)


def split_features(feature_u: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(c, n_trees, n_nodes) int64 split feature of each node for each mask
    of a (c, d) chunk: uniform over the mask's selected columns (the
    ``floor(u * n_selected)``-th of them). An all-zero mask splits on
    column 0, as the JAX package's categorical draw over all -inf logits
    does."""
    sel = (masks > 0).to(torch.int64)
    rank_end = torch.cumsum(sel, dim=1)  # (c, d): selected columns up to each column
    n_sel = rank_end[:, -1]
    u = feature_u.to(torch.float64)[None]
    r = torch.floor(u * n_sel[:, None, None].to(torch.float64)).to(torch.int64)
    r = torch.minimum(r, torch.clamp_min(n_sel - 1, 0)[:, None, None])
    c, (t, n) = masks.shape[0], feature_u.shape
    # the first column whose running count reaches r + 1 is the r-th selected one
    col = torch.searchsorted(rank_end, (r + 1).reshape(c, -1)).reshape(c, t, n)
    return torch.where(n_sel[:, None, None] > 0, col, 0)


def _level(level: int):
    return 2**level - 1, 2**level


def _fit(x_train, subsample, features, threshold_u, depth: int):
    """Per-node thresholds and sizes of each (mask, tree), and the leaves'
    sizes: ``(thr, size)`` (c, T, 2**depth - 1) and ``leaf`` (c, T, 2**depth)."""
    c, t = features.shape[:2]
    psi = subsample.shape[1]
    dtype = x_train.dtype
    flat = x_train.reshape(-1)
    row_off = (subsample * x_train.shape[1]).expand(c, t, psi)
    node = torch.zeros((c, t, psi), dtype=torch.int64, device=x_train.device)
    ones = torch.ones((c, t, psi), dtype=dtype, device=x_train.device)
    thr = torch.empty(features.shape, dtype=dtype, device=x_train.device)
    size = torch.empty(features.shape, dtype=dtype, device=x_train.device)
    for level in range(depth):
        off, n = _level(level)
        v = flat[row_off + torch.gather(features[..., off:off + n], 2, node)]
        shape = (c, t, n)
        mins = torch.full(shape, torch.inf, dtype=dtype, device=v.device).scatter_reduce(
            2, node, v, "amin")
        maxs = torch.full(shape, -torch.inf, dtype=dtype, device=v.device).scatter_reduce(
            2, node, v, "amax")
        sz = torch.zeros(shape, dtype=dtype, device=v.device).scatter_add(2, node, ones)
        u = threshold_u[:, off:off + n].to(dtype)
        # an empty node's min + u (max - min) is inf - inf: its threshold is 0
        # (no training point routes there; a test point stops on its size first)
        t_l = torch.where(sz > 0, mins + u * (maxs - mins), 0.0)
        thr[..., off:off + n] = t_l
        size[..., off:off + n] = sz
        node = 2 * node + (v > torch.gather(t_l, 2, node)).to(torch.int64)
    leaf = torch.zeros((c, t, 2**depth), dtype=dtype, device=x_train.device).scatter_add(
        2, node, ones)
    return thr, size, leaf


def _path_lengths(x_test, features, thr, size, leaf, depth: int) -> torch.Tensor:
    """(c, T, nt) path length h(x) of each test row through each tree."""
    c, t = features.shape[:2]
    nt, d = x_test.shape
    dtype = x_test.dtype
    flat = x_test.reshape(-1)
    row_off = (torch.arange(nt, device=x_test.device) * d).expand(c, t, nt)
    node = torch.zeros((c, t, nt), dtype=torch.int64, device=x_test.device)
    h = torch.zeros((c, t, nt), dtype=dtype, device=x_test.device)
    alive = torch.ones((c, t, nt), dtype=torch.bool, device=x_test.device)
    for level in range(depth):
        off, n = _level(level)
        # external node reached: at most one training point (0: an empty
        # region), where the path ends at h = level + c(size) = level
        stop = alive & (torch.gather(size[..., off:off + n], 2, node) <= 1.0)
        h = torch.where(stop, float(level), h)
        alive = alive & ~stop
        v = flat[row_off + torch.gather(features[..., off:off + n], 2, node)]
        node = 2 * node + (v > torch.gather(thr[..., off:off + n], 2, node)).to(torch.int64)
    # past the depth cap: depth + c(leaf size), from the leaves' table
    return torch.where(alive, depth + torch.gather(_c_factor(leaf), 2, node), h)


def iforest_from_draws(x_test: torch.Tensor, x_train: torch.Tensor, subsample: torch.Tensor,
                       features: torch.Tensor, threshold_u: torch.Tensor) -> torch.Tensor:
    """(c, nt) scores of the forests grown from explicit draws: ``subsample``
    (T, psi) train rows, ``features`` (c, T, 2**depth - 1) split features
    per mask, ``threshold_u`` (T, 2**depth - 1) uniforms. Deterministic."""
    psi = subsample.shape[1]
    depth = (features.shape[2] + 1).bit_length() - 1
    thr, size, leaf = _fit(x_train, subsample, features, threshold_u, depth)
    h = _path_lengths(x_test, features, thr, size, leaf, depth)
    c_psi = _c_factor(torch.full((), float(psi), dtype=x_test.dtype, device=x_test.device))
    return torch.exp2(-torch.mean(h, dim=1) / c_psi)


def iforest_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                          n_trees: int = 100, psi: int = DEFAULT_PSI,
                          seed: int = 0, draws: Optional[IForestDraws] = None) -> torch.Tensor:
    """Isolation-forest anomaly scores in the masked feature space: (nt,) in
    (0, 1] for a (d,) mask, (c, nt) for a (c, d) chunk; higher is more
    anomalous. The forest's draws are ``draws``, else :func:`draw_iforest`
    with ``seed``, so every chunk of an ensemble grows its trees from the
    same draws (the JAX package's ``key``). A serving export passes them,
    drawn before the trace, so that the program holds them as constants."""
    m = mask.to(device=x_test.device)
    m = m[None] if m.ndim == 1 else m
    if draws is None:
        draws = draw_iforest(x_train.shape[0], int(n_trees), psi, seed)
    sub, feat_u, thr_u = draws.to(x_test.device)
    features = split_features(feat_u, m)
    out = iforest_from_draws(x_test, x_train, sub, features, thr_u)
    return out[0] if mask.ndim == 1 else out


def iforest_scores(x_test, x_train, n_trees: int = 100, psi: int = DEFAULT_PSI, seed: int = 0,
                   device=None) -> np.ndarray:
    """Full-space isolation forest (all features selected): numpy in, numpy
    out, computed in float32 on ``device`` (``cuda`` when None)."""
    dev = resolve_device(device)
    xte = torch.as_tensor(np.asarray(x_test), dtype=torch.float32, device=dev)
    xtr = torch.as_tensor(np.asarray(x_train), dtype=torch.float32, device=dev)
    mask = torch.ones((xtr.shape[1],), dtype=torch.float32, device=dev)
    return iforest_scores_masked(xte, xtr, mask, n_trees=n_trees, psi=psi,
                                 seed=seed).cpu().numpy()
