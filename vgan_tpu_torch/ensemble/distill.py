"""Pseudo-supervised score approximation (suod's distillation stage).

After fitting an expensive unsupervised detector, a fast supervised
regressor is trained on ``(X_train -> detector's train scores)`` and served
in its place. The regressor is a random-Fourier-feature ridge regression
(Rahimi & Recht 2007): the feature map is one matmul and a cosine, the fit
one (F, F) eigendecomposition, inference two matmuls. Closed-form and
deterministic.

Three refinements over a single-bandwidth RFF ridge, as in ``vgan_tpu``:

- multi-scale features: the cosine block is split evenly across ``scales``
  x the median lengthscale;
- linear augmentation: the standardized inputs (scaled 1/sqrt(d)) are
  appended to the feature block;
- GCV ridge selection: ``ridge='gcv'`` (default) picks the ridge from a
  small grid by generalized cross-validation, closed-form through ONE
  eigendecomposition shared across the grid (the hat matrix's trace is
  sum s_i / (s_i + r n)).

The host part (standardization, the subsample, the numpy draws of W and b)
is the JAX package's, step for step, so one seed gives the same features.
The features are float32; the Gram, its ``eigh`` and the GCV are float64
on the device whatever the features' dtype (``vgan_tpu`` without
``jax_enable_x64`` solves in float32; ROADMAP.md Queue 3).
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device

# GCV grid for ridge='gcv' (scaled by n internally, like explicit ridges)
_GCV_RIDGES = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1)


def _rff_features(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_cos: int) -> torch.Tensor:
    """[sqrt(2/F_cos) cos(x @ W + b), x / sqrt(d)]: the multi-scale RFF map
    with the linear augmentation block, in ``x``'s dtype. ``W`` already
    carries the per-scale bandwidths in its columns."""
    z = torch.cos(x @ w + b[None, :]) * math.sqrt(2.0 / n_cos)
    return torch.cat([z, x / math.sqrt(x.shape[1])], dim=1)


def _rff_fit_gcv(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 ridges: torch.Tensor, n_cos: int):
    """Closed-form ridge solves over the grid ``ridges`` and their GCV scores.

    float64 normal equations through ONE (F, F) eigendecomposition: for each
    ridge r, beta_r = V diag(1/(s + r n)) V' Z'y, the hat matrix's trace is
    sum_i s_i / (s_i + r n), and GCV(r) = mean((y - Z beta)^2) /
    (1 - tr(H)/n)^2, all ridges in one batch. Eigenvector signs and order
    do not matter: beta = V f(s) V' Z'y. Returns (betas (R, F), gcvs (R,)),
    both float64."""
    z = _rff_features(x, w, b, n_cos).double()
    y = y.double()
    n = x.shape[0]
    s, v = torch.linalg.eigh(z.T @ z)
    s = torch.clamp(s, min=0.0)
    c = v.T @ (z.T @ y)
    denom = s[None, :] + ridges[:, None] * n
    betas = (c[None, :] / denom) @ v.T
    resid = y[None, :] - betas @ z.T
    eff = torch.sum(s[None, :] / denom, dim=1)
    gcvs = torch.mean(resid * resid, dim=1) / torch.square(1.0 - eff / n)
    return betas, gcvs


def _rff_predict(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, beta: torch.Tensor,
                 n_cos: int) -> torch.Tensor:
    return _rff_features(x, w, b, n_cos) @ beta


def _median_sq_dist(x: torch.Tensor) -> torch.Tensor:
    """Median pairwise squared distance (the RBF lengthscale heuristic): one
    Gram matmul on a bounded subsample. The n(n - 1) off-diagonal values are
    an even count; their median is the mean of the two middle ones, as
    ``jnp.nanmedian``'s (``torch.median`` would return the lower one)."""
    sq = torch.sum(x * x, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    off = ~torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    vals = torch.sort(torch.clamp(d2[off], min=0.0)).values
    mid = vals.numel() // 2
    return (vals[mid - 1] + vals[mid]) / 2 if mid else vals.new_tensor(float("nan"))


def _check_ridge(ridge) -> None:
    """'gcv' or a positive real scalar. Python and numpy reals alike
    (``numbers.Real``: ``np.float32``, ``np.int64``); a bool is not a ridge.
    ``vgan_tpu`` takes only ``int`` / ``float`` (and so ``np.float64`` and
    ``True``; ROADMAP.md Queue 3)."""
    if isinstance(ridge, str) and ridge == "gcv":
        return
    if not (isinstance(ridge, numbers.Real) and not isinstance(ridge, bool) and ridge > 0):
        raise ValueError(f"ridge must be positive or 'gcv'; got {ridge!r}")


class ScoreDistiller:
    """Fast supervised approximation of one detector's score function.

    Parameters
    ----------
    n_features:
        random Fourier feature count F (the cosine block; the linear
        augmentation adds d more). Fit cost is one (F + d, F + d)
        eigendecomposition.
    lengthscale:
        RBF kernel base lengthscale; 'median' (default) uses the median
        pairwise distance of a <=1024-row train subsample, or pass a float.
        The cosine block is split evenly across ``scales`` x this base.
    scales:
        bandwidth multipliers for the multi-scale cosine block.
    ridge:
        ridge regularizer (scaled by n internally), or 'gcv' (default):
        picked from a small grid by generalized cross-validation.
        ``ridge_`` records the selected value after ``fit``.
    seed:
        random feature draw (W, b): deterministic distillers.
    device:
        where the features, the solve and ``predict`` run: ``cuda`` when
        None (raises without a card); ``"cpu"`` only when asked for.

    ``fit`` standardizes inputs per dimension and targets to zero mean and
    unit variance; ``predict`` undoes the target transform.
    """

    def __init__(self, n_features: int = 512, lengthscale="median",
                 scales=(0.5, 1.0, 2.0, 4.0), ridge="gcv", seed: int = 0, device=None):
        if n_features < 1:
            raise ValueError(f"n_features must be >= 1; got {n_features}")
        _check_ridge(ridge)
        scales = tuple(float(s) for s in scales)
        if not scales or not all(s > 0 for s in scales):
            raise ValueError(
                f"scales must be a non-empty tuple of positive bandwidth "
                f"multipliers; got {scales!r}"
            )
        self.n_features = int(n_features)
        self.lengthscale = lengthscale
        self.scales = scales
        self.ridge = ridge if isinstance(ridge, str) else float(ridge)
        self.ridge_ = None
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._params = None
        self._gcvs = None

    def fit(self, x: np.ndarray, scores: np.ndarray):
        x = np.asarray(x, np.float32)
        y = np.asarray(scores, np.float32)
        if x.ndim != 2 or len(x) != len(y):
            raise ValueError(
                f"x (n, d) and scores (n,) disagree: {x.shape} vs {y.shape}"
            )
        mu = x.mean(axis=0)
        sd = x.std(axis=0) + 1e-9
        xs = (x - mu) / sd
        y_mu = float(y.mean())
        y_sd = float(y.std()) + 1e-12
        ys = (y - y_mu) / y_sd

        dev = self.device
        xs_t = torch.as_tensor(xs, device=dev)
        if self.lengthscale == "median":
            sub = xs_t[:: max(1, len(xs) // 1024)][:1024]
            med = float(_median_sq_dist(sub))
            ls = float(np.sqrt(max(med, 1e-12)))
        else:
            ls = float(self.lengthscale)
        rng = np.random.default_rng(self.seed)
        # multi-scale cosine block: n_features columns split evenly across
        # the bandwidth multipliers (remainder goes to the last scale)
        per = self.n_features // len(self.scales)
        counts = [per] * (len(self.scales) - 1)
        counts.append(self.n_features - per * (len(self.scales) - 1))
        w = np.concatenate([
            rng.normal(0.0, 1.0 / (ls * s), size=(x.shape[1], c))
            for s, c in zip(self.scales, counts)
        ], axis=1)
        b = rng.uniform(0.0, 2.0 * np.pi, size=self.n_features)
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        b = torch.as_tensor(b, dtype=torch.float32, device=dev)
        ridges = _GCV_RIDGES if self.ridge == "gcv" else (self.ridge,)
        betas, gcvs = _rff_fit_gcv(
            xs_t, torch.as_tensor(ys, device=dev), w, b,
            torch.tensor(ridges, dtype=torch.float64, device=dev), self.n_features,
        )
        self._gcvs = gcvs.cpu().numpy()
        pick = int(np.argmin(self._gcvs))
        self.ridge_ = float(ridges[pick])
        self._params = dict(
            w=w, b=b, beta=betas[pick].float(),
            x_mu=torch.as_tensor(mu, device=dev), x_sd=torch.as_tensor(sd, device=dev),
            y_mu=y_mu, y_sd=y_sd,
        )
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self._predict_torch(x).cpu().numpy()

    def _predict_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Tensor in, tensor out on the distiller's device: the function a
        serving export embeds (``vgan_tpu``'s ``_predict_jnp``)."""
        p = self._params
        if p is None:
            raise RuntimeError("call fit(x, scores) first")
        xs = (x - p["x_mu"][None, :]) / p["x_sd"][None, :]
        ys = _rff_predict(xs, p["w"], p["b"], p["beta"], self.n_features)
        return ys * p["y_sd"] + p["y_mu"]
