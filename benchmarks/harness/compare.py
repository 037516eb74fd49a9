"""The comparison that decides ``correct``: the program's readings against
the plain reference's, each as one number held to its limit
(``limits/<workload>.json``).

Training (the first steps of the window's own call, on the estimator the
window drives):

- ``loss``: the widest relative gap of a step's loss;
- ``grad``: the widest relative gap between the program's and the
  reference's norm of a parameter's first gradient as the optimizer is
  handed it (before its weight decay), over the parameters whose reference
  gradient is at least the median parameter's: a bias's gradient sums the
  batch's rows, which cancel, and its relative gap swings from seed to seed
  by two orders of magnitude under float32 rounding alone;
- ``change``: the same for each parameter's change over the first three
  steps, over the parameters whose reference gradient is at least a
  thousandth of the median parameter's (a gradient nought to rounding
  moves a parameter under Adadelta by round-off alone);
- kl also ``generator_loss``: the relative gap of the first generator
  epoch's mean loss, the MMD^2 of the encodings under the frozen bandwidth.

Scoring:

- ``score``: over every call of the window, the widest gap of a row's
  score relative to the largest reference score of its batch;
- ``kth``: over the set-up's call on each test batch, the widest relative
  gap of a k-th neighbour distance in a subspace, as the KNN kernel hands
  it to the ensemble (the aggregate averages 500 subspaces, so it hides
  what TF32 products do to each).
"""

from __future__ import annotations

import statistics

import numpy as np

IGNORE_GRAD_BELOW = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    keys = [k for k in ref if keep(k)]
    if set(prog) != set(ref):
        return float("inf")
    floor = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-300) for k in keys)


def fit_gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared for a fit, from ``recorder`` and ``reference``
    readings (``prog`` also carries ``generator_loss`` for kl)."""
    if (prog["grad_norms"] is None or prog["change_norms"] is None
            or len(prog["losses"]) != len(ref["losses"])):
        return {"loss": float("inf"), "grad": float("inf"), "change": float("inf")}
    losses = [_rel(p, r) if np.isfinite(p) else float("inf")
              for p, r in zip(prog["losses"], ref["losses"])]
    median_grad = statistics.median(ref["grad_norms"].values())
    moved = lambda k: ref["grad_norms"][k] >= IGNORE_GRAD_BELOW * median_grad  # noqa: E731
    large = lambda k: ref["grad_norms"][k] >= median_grad  # noqa: E731
    out = {
        "loss": max(losses),
        "grad": _leaf_gap(prog["grad_norms"], ref["grad_norms"], large),
        "change": _leaf_gap(prog["change_norms"], ref["change_norms"], moved),
    }
    if "generator_epoch_loss" in ref:
        p = prog.get("generator_epoch_loss", float("nan"))
        out["generator_loss"] = _rel(p, ref["generator_epoch_loss"]) if np.isfinite(p) else float("inf")
    return out


def score_gap(outputs, batch_of_call, ref: np.ndarray) -> float:
    """``outputs``: each call's (n_test,) scores; ``batch_of_call``: the
    test batch each call scored; ``ref``: (batches, n_test) reference
    scores."""
    worst = 0.0
    for out, b in zip(outputs, batch_of_call):
        out = np.asarray(out, dtype=np.float64)
        if out.shape != ref[b].shape or not np.all(np.isfinite(out)):
            return float("inf")
        worst = max(worst, float(np.max(np.abs(out - ref[b])) / np.max(np.abs(ref[b]))))
    return worst


def kth_gap(subspace_scores, kth: np.ndarray) -> float:
    """``subspace_scores``: the program's (n_masks, n_test) k-th distances
    of each test batch; ``kth``: the reference's (batches, n_masks,
    n_test)."""
    if len(subspace_scores) != len(kth):
        return float("inf")
    worst = 0.0
    for got, want in zip(subspace_scores, kth):
        got = np.asarray(got, dtype=np.float64)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            return float("inf")
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(want, 1e-300))))
    return worst


def judge(gaps: dict, limits: dict):
    """``(correct, checks)``: every number at or under its limit, and the
    numbers beside their limits, in the limits' order."""
    checks = {}
    correct = True
    for name, limit in limits["limits"].items():
        value = gaps.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
        correct = correct and bool(value <= limit)
    return correct, checks
