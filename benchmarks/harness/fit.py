"""Runs every ``"kind": "fit"`` traffic mix.

Set-up builds the configuration's estimator with no epochs (``fit`` with
``epochs=0`` makes the model and optimizer state from the weights' seed
and trains nothing), then drives it through the window's own call,
``continue_fit(X, epochs=check_epochs)``, while the recorder reads the
first steps: that warms every shape the window uses and gives the
readings that the reference is held to. The window then runs closed-loop
``continue_fit(X, epochs=epochs_per_call)`` calls on the same estimator
until ``seconds`` have passed, each ending in ``torch.cuda.synchronize()``:
the rate is every step of those calls over the whole window. Under the
'dp' layout every card runs this in a process of its own, over a mesh
with a 'data' axis of all of them."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import data, yardstick
from harness.device import peak_bytes, reset_peak, sync
from harness.recorder import StepRecorder
from harness.trace import Trace, span

CHECK_STEPS = 3
# The profiler covers the window's first whole calls past this many seconds
# (reading a longer trace would outlast a run's time limit).
TRACE_SECONDS = 6.0


def weights_seed(config: dict, seed: int) -> int:
    ws = config["weights_seed"]
    return int(seed) if ws == "run" else int(ws)


def build(ctx: Context, x: np.ndarray, mesh=None):
    """The configuration's estimator with its state made and no step taken."""
    import vgan_tpu_torch

    cls = getattr(vgan_tpu_torch, ctx.config["estimator"])
    est = cls(**ctx.config["params"], epochs=0, seed=weights_seed(ctx.config, ctx.seed),
              verbose=False, mesh=mesh, device=ctx.device)
    return est.fit(x)


def checked_steps(est, x: np.ndarray, check_epochs: int) -> dict:
    """The first steps through the window's own call, read by the recorder."""
    with StepRecorder(CHECK_STEPS) as rec:
        est.continue_fit(x, epochs=check_epochs)
    readings = rec.readings()
    history = est.train_history.get("generator_loss", [])
    if getattr(est, "_kl", False) and len(history) >= 2:
        readings["generator_epoch_loss"] = float(history[1])
    return readings


def steps_per_call(ctx: Context) -> int:
    n, batch = ctx.config["n"], ctx.config["params"]["batch_size"]
    return ctx.traffic["epochs_per_call"] * (n // min(batch, n))


def step_flops(ctx: Context, epochs: int) -> float:
    """Model FLOPs of ``epochs`` epochs of the window's calls."""
    cfg = ctx.config
    n, d, batch = cfg["n"], cfg["d"], cfg["params"]["batch_size"]
    nb = n // batch
    if cfg["kind"] == "no_kl":
        return epochs * nb * yardstick.no_kl_step_flops(batch, d)
    cycle = cfg["params"]["iternum_d"] + cfg["params"]["iternum_g"]
    det_epochs = epochs * cfg["params"]["iternum_d"] / cycle
    return nb * (det_epochs * yardstick.kl_detector_step_flops(batch, d)
                 + (epochs - det_epochs) * yardstick.kl_generator_step_flops(batch, d))


def rank0_says(ctx: Context, flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (its clock decides for the mesh)."""
    if ctx.world == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([1.0 if flag else 0.0], device=ctx.device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def run(ctx: Context, mesh=None) -> dict:
    from vgan_tpu_torch.ops.cuda import mmd_gram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_peak(ctx.device)
    x_dev = data.dataset(ctx.config, ctx.seed, ctx.device)
    x = x_dev.cpu().numpy()
    del x_dev
    est = build(ctx, x, mesh)
    prog = checked_steps(est, x, ctx.traffic["check_epochs"])
    sync(ctx.device)
    setup_s = time.time() - ctx.t_start

    epochs = ctx.traffic["epochs_per_call"]
    calls = failed = traced_calls = 0
    launches = None
    mmd_gram.reset_launch_counts()
    tr = Trace(ctx.trace)
    t0 = time.perf_counter()
    tr.start()
    while True:
        try:
            seen = len(est.train_history["generator_loss"])
            with span("continue_fit"):
                est.continue_fit(x, epochs=epochs)
            sync(ctx.device)
            new = [v for hist in est.train_history.values() for v in hist[seen:]]
            failed += int(not np.all(np.isfinite(new)))
        except (RuntimeError, ValueError) as err:  # a call that fails is counted, not fatal
            print(f"continue_fit failed: {err!r}", flush=True, file=sys.stderr)
            failed += 1
            sync(ctx.device)
        calls += 1
        elapsed = time.perf_counter() - t0
        if tr.active and rank0_says(ctx, tr.elapsed() >= TRACE_SECONDS):
            tr.stop()
            traced_calls, launches = calls, mmd_gram.launch_counts()
        if rank0_says(ctx, elapsed >= ctx.seconds):
            break
    window_s = time.perf_counter() - t0
    if tr.active:
        tr.stop()
        traced_calls, launches = calls, mmd_gram.launch_counts()
    out = {
        "setup_s": setup_s, "window_s": window_s, "calls": calls, "failed": failed,
        "steps": calls * steps_per_call(ctx), "memory_peak_bytes": peak_bytes(ctx.device),
        "program": prog, "trace": tr, "traced_calls": traced_calls,
        "traced_steps": traced_calls * steps_per_call(ctx),
        "launches": launches or mmd_gram.launch_counts(),
        "model_flops": step_flops(ctx, traced_calls * epochs),
    }
    del est
    return out


def reference_readings(ctx: Context, precision: str = "float64") -> dict:
    """The reference's readings on the same inputs, run once the program's
    state is freed."""
    import importlib

    ref = importlib.import_module(f"reference.{ctx.config['reference']}")
    x = data.dataset(ctx.config, ctx.seed, ctx.device)
    cfg = dict(ctx.config)
    return ref.follow(x, weights_seed(ctx.config, ctx.seed), cfg, precision, CHECK_STEPS)
