"""Runs every ``"kind": "score"`` traffic mix.

Set-up makes the train rows, the test batches and the masks on the device
from the seed, fits a ``SubspaceEnsemble`` of the mix's base over the masks
with uniform weights, and scores one batch (which builds and warms every
kernel). The window is one caller in a closed loop: ``decision_function``
on the test batches in turn until ``seconds`` have passed, each call timed
on the host clock from the call to the scores on the host. The rate is
every row scored over the whole window; the tail is over every call."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import data, yardstick
from harness.device import peak_bytes, reset_peak, sync
from harness.recorder import OutputRecorder
from harness.trace import Trace, span

TRACE_SECONDS = 6.0  # the profiler covers the window's first calls past this


def build(ctx, x_train: np.ndarray, masks: np.ndarray):
    from vgan_tpu_torch import SubspaceEnsemble

    t = ctx.traffic
    weights = np.full(len(masks), 1.0 / len(masks))
    return SubspaceEnsemble(masks, weights, base=t["base"], k=t["k"],
                            device=ctx.device).fit(x_train)


def checked_calls(ens, batches) -> list:
    """One call through the window's entry on each test batch (which also
    builds and warms every kernel), keeping the per-subspace scores that
    the KNN kernel hands the ensemble: (n_masks, n_test) a batch."""
    from vgan_tpu_torch.ensemble import od

    with OutputRecorder(od, "knn_scores_all_masks") as rec:
        for b in batches:
            ens.decision_function(b)
    return rec.outputs


def score_calls(ens, batches, calls: int):
    """``calls`` calls in the window's order, outside any window (the
    readings script's and the tests' path)."""
    return [ens.decision_function(batches[i % len(batches)]) for i in range(calls)]


def run(ctx) -> dict:
    from vgan_tpu_torch.ops.cuda import knn_score

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_peak(ctx.device)
    x_train, x_test, masks = data.score_inputs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    batches = [b.cpu().numpy() for b in x_test]
    masks_np = masks.cpu().numpy()
    n_selected = int(masks.sum())
    ens = build(ctx, x_train.cpu().numpy(), masks_np)
    del x_train, x_test, masks
    subspace_scores = checked_calls(ens, batches)
    sync(ctx.device)
    setup_s = time.time() - ctx.t_start

    outputs, latencies, order = [], [], []
    failed = traced_calls = 0
    launches = None
    knn_score.reset_launch_counts()
    tr = Trace(ctx.trace)
    t0 = time.perf_counter()
    tr.start()
    while True:
        b = len(outputs) % len(batches)
        t_call = time.perf_counter()
        try:
            with span("decision_function"):
                out = ens.decision_function(batches[b])
        except (RuntimeError, ValueError) as err:  # counted, not fatal
            print(f"decision_function failed: {err!r}", flush=True, file=sys.stderr)
            out = None
        latencies.append(time.perf_counter() - t_call)
        failed += int(out is None or not np.all(np.isfinite(out)))
        outputs.append(out)
        order.append(b)
        elapsed = time.perf_counter() - t0
        if tr.active and tr.elapsed() >= TRACE_SECONDS:
            tr.stop()
            traced_calls, launches = len(outputs), knn_score.launch_counts()
        if elapsed >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    if tr.active:
        tr.stop()
        traced_calls, launches = len(outputs), knn_score.launch_counts()
    t = ctx.traffic
    nt, ntr, d = t["n_test"], ctx.config["n"], ctx.config["d"]
    out = {
        "setup_s": setup_s, "window_s": window_s, "calls": len(outputs), "failed": failed,
        "rows": len(outputs) * nt, "latencies": latencies, "outputs": outputs, "order": order,
        "memory_peak_bytes": peak_bytes(ctx.device), "trace": tr,
        "launches": launches or knn_score.launch_counts(), "traced_calls": traced_calls,
        "call_ops": yardstick.knn_ops(n_selected, t["n_masks"], nt, ntr),
        "call_bound_ms": yardstick.knn_bound_ms(n_selected, t["n_masks"], nt, ntr, d),
        "n_selected": n_selected, "subspace_scores": subspace_scores,
    }
    del ens
    return out


def reference_scores(ctx, precision: str = "float64"):
    """``(scores, kth)``: the (batches, n_test) reference scores of every
    test batch and the (batches, n_masks, n_test) k-th neighbour distances
    in each subspace."""
    import importlib

    ref = importlib.import_module(f"reference.{ctx.traffic['reference']}")
    x_train, x_test, masks = data.score_inputs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    weights = torch.full((masks.shape[0],), 1.0 / masks.shape[0], device=ctx.device)
    scores, kth = ref.decision_function(x_test, x_train, masks, weights, ctx.traffic["k"],
                                        precision)
    return scores.cpu().numpy(), kth.cpu().numpy()
