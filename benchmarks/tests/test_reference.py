"""The plain references agree with the program at a small size, and the
control (the reference in TF32 in the program's place) fails the cell's
limits there."""

import time

import pytest
import torch

from harness import compare, data, fit, score
from harness.spec import Cell, Context


def _ctx(tiny_root, workload, seed):
    return Context(Cell(workload, tiny_root), seed, 0.0, False, torch.device("cpu"),
                       time.time())


def _fit_gaps(ctx, precision=None):
    ref = fit.reference_readings(ctx)
    if precision is not None:
        return compare.fit_gaps(fit.reference_readings(ctx, precision), ref)
    x = data.dataset(ctx.config, ctx.seed, ctx.device).numpy()
    est = fit.build(ctx, x)
    return compare.fit_gaps(fit.checked_steps(est, x, ctx.traffic["check_epochs"]), ref)


def _score_gap(ctx, precision=None):
    ref, kth = score.reference_scores(ctx)
    if precision is not None:
        out, raw = (list(a) for a in score.reference_scores(ctx, precision))
    else:
        x_train, x_test, masks = data.score_inputs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
        ens = score.build(ctx, x_train.numpy(), masks.numpy())
        batches = [b.numpy() for b in x_test]
        raw = score.checked_calls(ens, batches)
        out = score.score_calls(ens, batches, len(x_test))
    return {"score": compare.score_gap(out, range(len(out)), ref),
            "kth": compare.kth_gap(raw, kth)}


@pytest.mark.parametrize("workload", ["no_kl.fit", "kl.fit"])
@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_fit_reference_matches_program(tiny_root, workload, seed):
    gaps = _fit_gaps(_ctx(tiny_root, workload, seed))
    assert set(gaps) == set(Cell(workload, tiny_root).limits["limits"])
    assert max(gaps.values()) < 1e-4, gaps


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_score_reference_matches_program(tiny_root, seed):
    gaps = _score_gap(_ctx(tiny_root, "no_kl.score", seed))
    assert max(gaps.values()) < 1e-5, gaps


@pytest.mark.parametrize("workload", ["no_kl.fit", "kl.fit", "no_kl.score"])
def test_control_in_tf32_is_refused(tiny_root, workload):
    ctx = _ctx(tiny_root, workload, 5)
    gaps = _fit_gaps(ctx, "tf32") if workload.endswith("fit") else _score_gap(ctx, "tf32")
    correct, checks = compare.judge(gaps, ctx.cell.limits)
    assert not correct, checks
