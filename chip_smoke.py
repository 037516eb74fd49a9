#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (vgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):

1. card identity: name and power limit, TF32 off, build the CUDA kernels;
2. every kernel against its plain PyTorch version on the card, twice for
   identical bits, then the kernel autograd Function against the dense
   torch MMD in all three backward regimes (stash, flash, panel);
3. the main path at full width: ``VGAN_no_kl`` fit at the stress
   configuration (n=2000, d=10240, batch 500, 2 epochs), then
   generate_subspaces, approx_subspace_dist and check_if_myopic;
4. the other regimes through ``fit`` (d=1024 flash; d=10240 with the K'
   stash off, panel), and the d=10 notebook configuration, which runs no
   kernel. Every kernel fit's losses are held against the same fit on the
   dense torch path;
5. CUDA-event times of each kernel and its plain version, bounds, the
   stress fit's steps/s, and a profiler breakdown of one stress epoch by
   device kernel with the device's busy share.

Prints a JSON line of the kernels, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device. Imports nothing of JAX or ``vgan_tpu``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): non-tensor float32 rate and
# HBM3 bandwidth, the denominators of the bounds below.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Operations per Gram entry beside the distance product (d2 assembly, one
# exp, the integer-power ladder and its sums), counted into the bounds.
OPS_PER_ENTRY = 20

STRESS = dict(n=2000, d=10240, batch=500)  # bench.py's "no-kl stress" shape

# Tolerances, each with its reason:
# quadrant sums: same f32 inputs, sums of m^2 positive terms; the kernel and
# the plain version differ only in summation order (d-chunk FMA order and
# the reduction tree), a few ulp of the terms each, far below 1e-5.
RTOL_SUMS = 1e-5
# K' entries: ulp-level differences of exp and of the d2 dot product;
# atol covers entries near 0 (K' ~ 1/bw ~ 1e-4 at the stress shape).
RTOL_KP, ATOL_KP = 1e-5, 1e-7
# gradients and S @ z: signed sums over m terms that partly cancel, so the
# error is held against the largest entry, not entrywise.
GRAD_FRAC = 1e-4
# the fit's per-epoch losses on the kernel path vs the dense torch path:
# eight Adadelta steps compound f32 rounding differences of ~1e-6.
RTOL_FIT_LOSS = 1e-3


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed no card")
    return out[0].strip()


def make_pair(n1: int, n2: int, d: int, seed: int, device):
    """x ~ N(0, 1); y = a masked copy of other rows, as the no-kl loss
    compares a batch with its projection."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n1, d), dtype=np.float32)
    keep = (rng.random(d) < 0.5).astype(np.float32)
    y = rng.standard_normal((n2, d), dtype=np.float32) * keep
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def gram_inputs(n1, n2, d, seed, device):
    from vgan_tpu_torch.ops import mmd as M

    x, y = make_pair(n1, n2, d, seed, device)
    z = torch.cat([x, y]).contiguous()
    norms = torch.sum(z * z, dim=1)
    bw = M.candidate_bandwidth(z).to(torch.float32)
    return x, y, z, norms, bw


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def assert_close(name, got, want, rtol, atol=0.0) -> float:
    err = max_abs(got, want)
    ok = bool(torch.all(torch.abs(got - want) <= atol + rtol * torch.abs(want)))
    check(ok, f"{name}: kernel disagrees with the plain version (max abs err {err:.3e})")
    return err


def assert_frac(name, got, want, frac) -> float:
    err = max_abs(got, want)
    lim = frac * float(torch.max(torch.abs(want)))
    check(err <= lim, f"{name}: max abs err {err:.3e} > {lim:.3e}")
    return err


def repeat_identical(name, fn) -> None:
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    sync()
    for u, v in zip(a, b):
        check(torch.equal(u, v), f"{name}: two runs gave different bits")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(device, gram_shapes, flash_shapes, log):
    """Each kernel against its plain version; returns the max abs error of
    each kernel at each shape, keyed ``(name, (n1, n2, d))``."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    errs = {}
    for n1, n2, d in gram_shapes:
        shape = (n1, n2, d)
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=11, device=device)
        tag = f"({n1}+{n2}, d={d})"

        s_k = G.gram_quadrant_sums(z, norms, bw, n1, mults)
        s_p = G.gram_quadrant_sums_reference(z, norms, bw, n1, mults)
        errs["gram_quadrant_sums", shape] = assert_close(
            f"gram_quadrant_sums {tag}", s_k, s_p, RTOL_SUMS)
        repeat_identical("gram_quadrant_sums", lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults))

        (s_k, kp_k) = G.gram_quadrant_sums_stash(z, norms, bw, n1, mults)
        (s_p, kp_p) = G.gram_quadrant_sums_stash_reference(z, norms, bw, n1, mults)
        e1 = assert_close(f"gram_quadrant_sums_stash sums {tag}", s_k, s_p, RTOL_SUMS)
        e2 = assert_close(f"gram_quadrant_sums_stash kp {tag}", kp_k, kp_p, RTOL_KP, ATOL_KP)
        errs["gram_quadrant_sums_stash", shape] = max(e1, e2)
        repeat_identical("gram_quadrant_sums_stash",
                         lambda: G.gram_quadrant_sums_stash(z, norms, bw, n1, mults))

        # the full square panel, then a ragged row panel against all columns
        errs["kprime_panel", shape] = 0.0
        for r0, r1 in ((0, z.shape[0]), (37, min(z.shape[0], 37 + 300))):
            zr, nr = z[r0:r1], norms[r0:r1]
            p_k = G.kprime_panel(zr, z, nr, norms, bw, mults)
            p_p = G.kprime_panel_reference(zr, z, nr, norms, bw, mults)
            e = assert_close(f"kprime_panel rows {r0}:{r1} {tag}", p_k, p_p, RTOL_KP, ATOL_KP)
            errs["kprime_panel", shape] = max(errs["kprime_panel", shape], e)
        repeat_identical("kprime_panel", lambda: G.kprime_panel(z, z, norms, norms, bw, mults))
        log(f"  K1 K2 K4 {tag}: ok")

    for n1, n2, d in flash_shapes:
        _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=12, device=device)
        tag = f"({n1}+{n2}, d={d})"
        sz_k, rs_k = G.gram_backward_flash(z, norms, bw, n1, n2, mults)
        sz_p, rs_p = G.gram_backward_flash_reference(z, norms, bw, n1, n2, mults)
        e1 = assert_frac(f"gram_backward_flash sz {tag}", sz_k, sz_p, GRAD_FRAC)
        e2 = assert_frac(f"gram_backward_flash rs {tag}", rs_k, rs_p, GRAD_FRAC)
        errs["gram_backward_flash", (n1, n2, d)] = max(e1, e2)
        repeat_identical("gram_backward_flash",
                         lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults))
        log(f"  K3 {tag}: ok")
    return errs


def phase_core(device, stash_shape, flash_shape, log):
    """The autograd Function against the dense torch MMD, three regimes."""
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    saved = G._KP_STASH_BYTES
    try:
        for want, shape in (("stash", stash_shape), ("flash", flash_shape), ("panel", stash_shape)):
            if want == "panel":
                G._KP_STASH_BYTES = 0
            n1, n2, d = shape
            check(G.regime(n1 + n2, d) == want, f"shape {shape} is not in the {want} regime")
            x, y, _, _, bw = gram_inputs(n1, n2, d, seed=13, device=device)
            G.reset_launch_counts()
            xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
            v_k = G.mmd2_cuda_core(xk, yk, bw, mults)
            gx_k, gy_k = torch.autograd.grad(v_k, (xk, yk))
            counts = G.launch_counts()
            xp, yp = x.clone().requires_grad_(), y.clone().requires_grad_()
            v_p, _ = M.mmd2_biased(xp, yp, bandwidth=bw, mults=mults)
            gx_p, gy_p = torch.autograd.grad(v_p, (xp, yp))
            # MMD^2 is a difference of the quadrant means: hold the value to
            # their scale, not to the (possibly cancelling) difference
            s = G.gram_quadrant_sums_reference(torch.cat([x, y]), torch.sum(torch.cat([x, y]) ** 2, 1), bw, n1, mults)
            scale = float(s[0, 0] / n1**2 + 2 * s[0, 1] / (n1 * n2) + s[0, 2] / n2**2)
            v_k, v_p = float(v_k.detach()), float(v_p.detach())
            check(abs(v_k - v_p) <= RTOL_SUMS * scale, f"core value {want}: {v_k} vs {v_p}")
            assert_frac(f"core grad x {want}", gx_k, gx_p, GRAD_FRAC)
            assert_frac(f"core grad y {want}", gy_k, gy_p, GRAD_FRAC)
            expected = {"stash": {"gram_quadrant_sums_stash"},
                        "flash": {"gram_quadrant_sums", "gram_backward_flash"},
                        "panel": {"gram_quadrant_sums", "kprime_panel"}}[want]
            check({k for k, v in counts.items() if v} == expected,
                  f"core {want} launched {counts}, expected {sorted(expected)}")
            log(f"  core {want} {shape}: value {v_k:.6e} vs {v_p:.6e}, grads ok")
    finally:
        G._KP_STASH_BYTES = saved


# ---------------------------------------------------------------------------
# phases 3-4: fits through the public estimator
# ---------------------------------------------------------------------------


def fit_counts(X, device, **kw):
    from vgan_tpu_torch import VGAN_no_kl
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    model = VGAN_no_kl(verbose=False, device=device, **kw)
    sync()
    G.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(X)
    sync()
    seconds = time.perf_counter() - t0
    counts = G.launch_counts()
    losses = np.asarray(model.train_history["generator_loss"])
    check(np.all(np.isfinite(losses)), f"non-finite loss history {losses}")
    return model, counts, losses, seconds


def fit_against_dense(X, device, label, log, **kw):
    """A fit on the default (kernel) path, then the same fit (same seed and
    streams) on the dense torch path; their loss histories must agree."""
    model, counts, losses, seconds = fit_counts(X, device, **kw)
    log(f"  {label}: losses {losses.tolist()} in {seconds:.3f} s, launches {counts}")
    _, plain_counts, plain_losses, _ = fit_counts(X, device, mmd_impl="torch", **kw)
    check(sum(plain_counts.values()) == 0, f"mmd_impl='torch' launched {plain_counts}")
    check(np.allclose(losses, plain_losses, rtol=RTOL_FIT_LOSS, atol=0.0),
          f"{label}: kernel-path losses {losses} vs dense-path {plain_losses}")
    log(f"  {label}: dense torch path losses {plain_losses.tolist()} agree within {RTOL_FIT_LOSS}")
    return model, counts, losses


def phase_main_path(device, n, d, batch, log):
    """The stress fit -> sample -> GoF workflow; returns the K2 launches."""
    X = np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)
    steps = 2 * (n // batch)
    model, counts, losses = fit_against_dense(X, device, "stress fit", log,
                                              epochs=2, batch_size=batch)
    check(counts["gram_quadrant_sums_stash"] == steps,
          f"stress fit launched the stash kernel {counts['gram_quadrant_sums_stash']} times, "
          f"expected {steps}")
    check(sum(counts.values()) == steps, f"stress fit launched other kernels: {counts}")

    masks = model.generate_subspaces(batch)
    check(masks.shape == (batch, d) and masks.dtype == np.bool_, f"masks {masks.shape} {masks.dtype}")
    check(np.array_equal(masks, model.generate_subspaces(batch)), "generate_subspaces not deterministic")
    model.approx_subspace_dist()
    check(abs(float(np.sum(model.proba)) - 1.0) < 1e-9, "subspace probabilities do not sum to 1")
    gof = model.check_if_myopic(X, count=batch)
    p = gof.to_numpy().ravel()
    check(np.all((p >= 0.0) & (p <= 1.0)), f"p-values out of [0, 1]: {p}")
    log(f"  {len(model.subspaces)} unique masks, top probability {float(np.max(model.proba)):.4f}, "
        f"GoF p-values {p.tolist()}")
    return counts["gram_quadrant_sums_stash"], float(losses[-1])


def phase_other_regimes(device, n, d_flash, d_panel, batch, log):
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    steps = n // batch
    launches = {}
    X = np.random.default_rng(1).standard_normal((n, d_flash), dtype=np.float32)
    _, counts, _ = fit_against_dense(X, device, f"flash fit d={d_flash}", log,
                                     epochs=2, batch_size=batch)
    check(counts == {"gram_quadrant_sums": 2 * steps, "gram_quadrant_sums_stash": 0,
                     "gram_backward_flash": 2 * steps, "kprime_panel": 0},
          f"flash fit launches {counts}, expected {2 * steps} of K1 and K3")
    launches["gram_quadrant_sums"] = counts["gram_quadrant_sums"]
    launches["gram_backward_flash"] = counts["gram_backward_flash"]

    saved = G._KP_STASH_BYTES
    G._KP_STASH_BYTES = 0
    try:
        X = np.random.default_rng(2).standard_normal((n, d_panel), dtype=np.float32)
        _, counts, _ = fit_against_dense(X, device, f"panel fit d={d_panel}", log,
                                         epochs=1, batch_size=batch)
    finally:
        G._KP_STASH_BYTES = saved
    check(counts["gram_quadrant_sums"] == steps and counts["kprime_panel"] >= steps
          and counts["gram_quadrant_sums_stash"] == 0 and counts["gram_backward_flash"] == 0,
          f"panel fit launches {counts}, expected {steps} of K1 and >= {steps} of K4")
    launches["kprime_panel"] = counts["kprime_panel"]

    # the reference notebook's configuration (d=10): dense torch path, no kernel
    rng = np.random.default_rng(0)
    cov = np.eye(10)
    for i, j in [(0, 8), (0, 9), (8, 9)]:
        cov[i, j] = cov[j, i] = 500
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Xn = rng.multivariate_normal([0] * 10, cov, 2000)
    model, counts, losses, _ = fit_counts(Xn, device, epochs=15, lr=0.001)
    check(sum(counts.values()) == 0, f"the d=10 notebook fit launched kernels: {counts}")
    model.approx_subspace_dist()
    log(f"  notebook config d=10: final loss {losses[-1]:.6f} (reference band about 2.5-5), "
        f"{len(model.subspaces)} unique masks (band < 20), top probability "
        f"{float(np.max(model.proba)):.4f}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(device, stress_shape, flash_shape, errs, launches, log):
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    mults = M.bandwidth_multipliers()
    src = "vgan_tpu_torch/ops/cuda/csrc/mmd_gram.cu"
    pallas = "vgan_tpu/ops/pallas/mmd_gram.py"
    rows = []

    def entry(name, replaces, shape, fn, plain, ops, nbytes, tol):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain)
        b_ms, b_by = bound(ops, nbytes)
        n1, n2, d = shape
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "shape": f"m={n1 + n2} d={d}", "launches": launches[name],
            "max_abs_err": errs[name, shape], "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        log(f"  {name} m={n1 + n2} d={d}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by})")

    n1, n2, d = flash_shape
    _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=21, device=device)
    m = n1 + n2
    entry("gram_quadrant_sums", f"{pallas}:207 _fwd_kernel", flash_shape,
          lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults),
          lambda: G.gram_quadrant_sums_reference(z, norms, bw, n1, mults),
          2 * m * m * d + OPS_PER_ENTRY * m * m, 4 * (m * d + m + 1 + 4), f"rtol {RTOL_SUMS}")
    entry("gram_backward_flash", f"{pallas}:469 _flash_bwd_kernel", flash_shape,
          lambda: G.gram_backward_flash(z, norms, bw, n1, n2, mults),
          lambda: G.gram_backward_flash_reference(z, norms, bw, n1, n2, mults),
          4 * m * m * d + OPS_PER_ENTRY * m * m, 4 * (2 * m * d + 2 * m + 1),
          f"{GRAD_FRAC} of max|ref|")

    n1, n2, d = stress_shape
    _, _, z, norms, bw = gram_inputs(n1, n2, d, seed=22, device=device)
    m = n1 + n2
    entry("gram_quadrant_sums_stash", f"{pallas}:269 _fwd_stash_kernel", stress_shape,
          lambda: G.gram_quadrant_sums_stash(z, norms, bw, n1, mults),
          lambda: G.gram_quadrant_sums_stash_reference(z, norms, bw, n1, mults),
          2 * m * m * d + OPS_PER_ENTRY * m * m, 4 * (m * d + m + 1 + 4 + m * m),
          f"sums rtol {RTOL_SUMS}; kp rtol {RTOL_KP} atol {ATOL_KP}")
    entry("kprime_panel", f"{pallas}:606 _kprime_panel_kernel", stress_shape,
          lambda: G.kprime_panel(z, z, norms, norms, bw, mults),
          lambda: G.kprime_panel_reference(z, z, norms, norms, bw, mults),
          2 * m * m * d + OPS_PER_ENTRY * m * m, 4 * (2 * m * d + 2 * m + 1 + m * m),
          f"rtol {RTOL_KP} atol {ATOL_KP}")
    order = ["gram_quadrant_sums", "gram_quadrant_sums_stash", "gram_backward_flash", "kprime_panel"]
    return sorted(rows, key=lambda r: order.index(r["name"]))


def fit_steps_per_s(device, n, d, batch, epochs: int = 2) -> float:
    from vgan_tpu_torch.train.steps import TrainConfig, init_no_kl_state, no_kl_train_epochs

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    config = TrainConfig(ndims=d, batch_size=batch)
    state = init_no_kl_state(config, 777, device)
    sync()
    t0 = time.perf_counter()
    _, losses = no_kl_train_epochs(state, x, config, epochs)
    sync()
    dt = time.perf_counter() - t0
    check(bool(torch.all(torch.isfinite(losses))), "non-finite losses in the timed fit")
    return epochs * (n // batch) / dt


def profile_stress_epoch(device, n, d, batch, log, top: int = 12) -> None:
    """Device time by kernel over one stress epoch (after a warm-up epoch),
    and the device's busy share of that epoch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vgan_tpu_torch.train.steps import TrainConfig, init_no_kl_state, no_kl_epoch

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    config = TrainConfig(ndims=d, batch_size=batch)
    state, _ = no_kl_epoch(init_no_kl_state(config, 777, device), x, config)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        no_kl_epoch(state, x, config)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    steps = n // batch
    log(f"  profiled stress epoch: {steps} steps, wall {wall_us / 1e3:.3f} ms "
        f"({wall_us / 1e3 / steps:.3f} ms/step), device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall; the profiler's own cost included)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {100 * e.self_device_time_total / max(busy_us, 1e-9):5.1f}%"
            f"  x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import vgan_tpu_torch
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    here = Path(__file__).resolve().parent
    check(Path(vgan_tpu_torch.__file__).resolve().parent.parent == here,
          f"vgan_tpu_torch was imported from {vgan_tpu_torch.__file__}, not from {here}")

    def log(msg):
        print(msg, flush=True)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    log("phase 1: card")
    card = card_identity()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    G._lib()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_info["mmd_gram"]["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    n, d, batch = STRESS["n"], STRESS["d"], STRESS["batch"]
    d_flash = 1024
    stress_shape = (batch, batch, d)   # the stress and panel fits' Gram
    flash_shape = (batch, batch, d_flash)  # the flash fit's Gram
    log("phase 2: kernels against their plain versions")
    errs = phase_kernels(device, [stress_shape, flash_shape, (333, 517, 2500)],
                         [flash_shape, (4096, 4096, 1024), (333, 517, 2000)], log)
    phase_core(device, stress_shape, (333, 517, 2000), log)

    log("phase 3: main path at full width")
    k2_launches, _ = phase_main_path(device, n, d, batch, log)

    log("phase 4: the other regimes through fit")
    launches = phase_other_regimes(device, n, d_flash, d, batch, log)
    launches["gram_quadrant_sums_stash"] = k2_launches

    log("phase 5: times")
    rows = phase_times(device, stress_shape, flash_shape, errs, launches, log)
    sps = fit_steps_per_s(device, n, d, batch)
    log(f"  stress fit (n={n}, d={d}, batch {batch}): {sps:.2f} steps/s")
    profile_stress_epoch(device, n, d, batch, log)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
