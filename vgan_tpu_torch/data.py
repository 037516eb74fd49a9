"""Dataset utilities of the example workflows and the CLI (counterpart of
``vgan_tpu.data``).

The reference demos on a synthetic correlated Gaussian (test.ipynb cell 2)
and its experiment branches sweep ADBench tabular datasets. Offered here:
the same synthetic family, sklearn's bundled tabular datasets (digits is
the image-as-features configuration: 64 pixel features), ADBench files from
a local path, and generic ``.npy`` / ``.npz`` / ``.csv`` loading. Nothing is
downloaded. sklearn is imported only inside :func:`sklearn_dataset`.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def notebook_gaussian(n: int = 2000, d: int = 10, coupled=(0, 8, 9), cov_value: float = 500.0,
                      seed: Optional[int] = None) -> np.ndarray:
    """The demo notebook's data family (test.ipynb cell 2): unit-variance
    Gaussian with a strongly coupled feature group. The notebook's literal
    covariance (off-diagonal 500 with unit diagonal) is not PSD; the same
    construction is kept, with the warning numpy emits suppressed."""
    rng = np.random.default_rng(seed)
    cov = np.eye(d)
    for i in coupled:
        for j in coupled:
            if i != j:
                cov[i, j] = cov_value
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return rng.multivariate_normal(np.zeros(d), cov, size=n)


def correlated_gaussian(n: int = 2000, d: int = 10, coupled=(0, 8, 9), rho: float = 0.95,
                        seed: Optional[int] = None) -> np.ndarray:
    """PSD variant of the notebook family (correlation ``rho`` in the
    coupled block)."""
    rng = np.random.default_rng(seed)
    cov = np.eye(d)
    for i in coupled:
        for j in coupled:
            if i != j:
                cov[i, j] = rho
    return rng.multivariate_normal(np.zeros(d), cov, size=n)


def load_tabular(path) -> np.ndarray:
    """Load a dataset from .npy / .npz (first array) / .csv."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".npz":
        z = np.load(path)
        return z[list(z.keys())[0]]
    if path.suffix == ".csv":
        from vgan_tpu_torch.io_native import load_csv

        return load_csv(path)
    raise ValueError(f"unsupported data format: {path.suffix}")


def load_adbench(path) -> Tuple[np.ndarray, np.ndarray]:
    """Load one ADBench dataset file from a local path (Han et al. 2022; the
    benchmark the reference's experiment branches drive).

    ADBench ships every dataset as an ``.npz`` with keys ``'X'`` (n, d
    float) and ``'y'`` (n, 0/1 int; 1 = anomaly). Returns ``(X float32 (n,
    d), y int64 (n,))`` and checks that contract loudly."""
    path = Path(path)
    z = np.load(path)
    missing = {"X", "y"} - set(z.keys())
    if missing:
        raise ValueError(
            f"{path.name} is not an ADBench file: missing key(s) {sorted(missing)} (ADBench "
            ".npz files carry 'X' (n, d) and 'y' (n,) with y=1 marking anomalies)"
        )
    x = np.asarray(z["X"], np.float32)
    y = np.asarray(z["y"]).reshape(-1).astype(np.int64)
    if x.ndim != 2 or len(x) != len(y):
        raise ValueError(f"{path.name}: X {x.shape} and y {y.shape} disagree")
    labels = set(np.unique(y).tolist())
    if not labels <= {0, 1}:
        raise ValueError(f"{path.name}: y must be 0/1 (1 = anomaly); got {sorted(labels)}")
    return x, y


def sklearn_dataset(name: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Bundled sklearn datasets (no network): digits, wine, breast_cancer,
    iris. ``digits`` is the image-as-features configuration (8x8 pixel
    features). Returns (X, y)."""
    from sklearn import datasets

    loaders = {
        "digits": datasets.load_digits,
        "wine": datasets.load_wine,
        "breast_cancer": datasets.load_breast_cancer,
        "iris": datasets.load_iris,
    }
    if name not in loaders:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(loaders)}")
    ds = loaders[name]()
    return np.asarray(ds.data, dtype=np.float64), np.asarray(ds.target)
