"""The whole no-kl fit in one launch, through the K8 kernel (counterpart of
``vgan_tpu.ops.pallas.fused_no_kl``).

One train step is: the batch, rows ``[start, start + bs)`` of a pre-permuted
dataset read at a per-epoch cyclic offset ("rotational batching"); latent
noise; the 4-layer linear generator; the upper softmax; the constrained
multi-bandwidth MMD between the batch and its masked copy with the
bandwidth frozen at step 0; the coverage penalty; the hand-written backward;
and torch-parity Adadelta. :func:`fused_no_kl_fit` runs every step of a fit:
on a CUDA tensor as one launch of K8 (``csrc/fused_no_kl.cu``), on a CPU
tensor through the plain version :func:`fused_no_kl_fit_reference`, which
runs the same schedule and the same arithmetic one step after another.

The math per step is the scan path's (``train/steps.py``); the random
streams are not. The dataset permutation, the offsets and the kernel's seed
come from three ``torch.Generator`` streams seeded from ``seed``; on the card
the noise comes from a counter-based Philox inside the kernel, keyed by
(seed, step, row, lane) (:func:`philox_normal` writes the same numbers into a
buffer); on the CPU it is drawn from the seed's third stream. ``noise=``,
``offsets=`` and ``perm=`` inject them (the tests hand JAX's draws to both).

Layout: the JAX package's padded one. W is (4, 128, 128) in (in, out) order
(the port's ``Linear`` weights are (out, in), so packing transposes), b is
(8, 128); padded entries stay 0.

Supported regime: the JAX package's, on its constants (``fused_supported``);
outside it the estimator raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vgan_tpu_torch.ops import mmd as _mmd
from vgan_tpu_torch.ops.cuda import _build
from vgan_tpu_torch.ops.cuda._build import check, launch, round_up

# The JAX package's constants (vgan_tpu/ops/pallas/fused_no_kl.py), kept
# because they define the supported regime.
LP = 128            # padded latent lanes
DP = 128            # padded feature lanes
WP = 128            # padded hidden width
MAX_MP = 2048       # Gram row cap
MAX_N_VMEM = 16384  # dataset rows resident on chip
RHO, EPS = 0.9, 1e-6
_MAX_LADDER = 8
# K8's phases, in the order of its phase timer (csrc/fused_no_kl.cu PHASES):
# the rows (A), the step-0 bandwidth, the column max, ties and Gram pass (B),
# the loss and row backward (E), the weight gradients and Adadelta (G).
PHASES = ("rows", "bandwidth", "gram", "backward", "update")


def fused_supported(n: int, d: int, bs: int, latent: int) -> bool:
    """The JAX package's gate of the fused path."""
    bsp = round_up(bs, 64)
    return (
        d <= DP
        and latent <= 16
        and 8 * latent <= WP
        and 2 * bsp <= MAX_MP
        and n + bsp <= MAX_N_VMEM
        and bs >= 2
    )


def ladder(mults: Tuple[float, ...]):
    """``(base, ((power, mult), ...))`` sorted by power: one exp at ``base``
    and iterated squarings reach every power. Raises ``ValueError`` unless
    the exponents are powers of two."""
    structure = _mmd.ladder_exponents(mults)
    if structure is None:
        raise ValueError("the fused path requires a geometric bandwidth ladder")
    base, ints = structure
    if any(i & (i - 1) for i in ints):
        raise ValueError(f"the fused path requires power-of-two ladder exponents, got {ints}")
    if len(ints) > _MAX_LADDER:
        raise ValueError(f"the fused path takes at most {_MAX_LADDER} bandwidths")
    return base, tuple(sorted(zip(ints, mults)))


def _widths(latent: int, d: int):
    return [latent, 2 * latent, 4 * latent, 8 * latent, d]


def pack_params(state: Dict[str, torch.Tensor], latent: int, d: int, device=None,
                dtype=torch.float32):
    """``main.{i}.{weight, bias}`` tensors (a generator's, or an Adadelta
    state's) -> padded W (4, WP, WP) in (in, out) order and b (8, WP)."""
    widths = _widths(latent, d)
    device = device if device is not None else state["main.0.weight"].device
    w = torch.zeros((4, WP, WP), dtype=dtype, device=device)
    b = torch.zeros((8, WP), dtype=dtype, device=device)
    for i in range(4):
        w[i, : widths[i], : widths[i + 1]] = state[f"main.{i}.weight"].detach().T
        b[i, : widths[i + 1]] = state[f"main.{i}.bias"].detach()
    return w, b


def unpack_params(w: torch.Tensor, b: torch.Tensor, latent: int, d: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_params`."""
    widths = _widths(latent, d)
    out = {}
    for i in range(4):
        out[f"main.{i}.weight"] = w[i, : widths[i], : widths[i + 1]].T.contiguous()
        out[f"main.{i}.bias"] = b[i, : widths[i + 1]].clone()
    return out


def streams(seed: int):
    """Three independent generators (permutation, offsets, kernel seed and
    host noise), as the JAX function splits its key in three."""
    g = torch.Generator().manual_seed(int(seed))
    subs = torch.randint(0, 2**62, (3,), generator=g).tolist()
    return [torch.Generator().manual_seed(int(s)) for s in subs]


def schedule(x: torch.Tensor, bs: int, epochs: int, perm, offsets, g_perm, g_off):
    """The schedule: ``(x3, step_starts, perm, offsets)``. x3, on x's device
    and of its dtype, is the pre-permuted dataset, zero-padded to DP lanes,
    with a wraparound tail of BSP rows that cycles the rows (as
    ``np.resize`` does, so n < BSP works); step ``e nb + i`` reads rows
    ``[(offset_e + i bs) % n, + bs)``. The starts, perm and offsets are host
    arrays."""
    n, d = x.shape
    nb = n // bs
    bsp = round_up(bs, 64)
    if perm is None:
        perm = torch.randperm(n, generator=g_perm).numpy()
    perm = np.asarray(perm, dtype=np.int64).reshape(n)
    if offsets is None:
        offsets = torch.randint(0, n, (epochs,), generator=g_off).numpy()
    offsets = np.asarray(offsets, dtype=np.int64).reshape(epochs)
    rows = torch.from_numpy(np.concatenate([perm, perm[np.arange(bsp) % n]])).to(x.device)
    x3 = torch.zeros((n + bsp, DP), dtype=x.dtype, device=x.device)
    x3[:, :d] = x[rows]
    starts = ((offsets[:, None] + np.arange(nb)[None, :] * bs) % n).reshape(-1)
    return x3, starts, perm, offsets.astype(np.int32)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def fused_no_kl_fit_reference(x3, starts, w, b, sqw, sqb, accw, accb, noise, *, d: int, bs: int,
                              latent: int, lr: float, weight_decay: float,
                              penalty_weight: float):
    """The whole fit, one step after another, on the padded layout; the
    arithmetic of K8 (and of the Pallas kernel), with the rank-1 backward
    written out. ``starts``: the per-step first rows (host ints); ``noise``:
    (T, r, l) with the step's noise in ``[:bs, :latent]``. Takes float32 or
    float64 (all inputs of one dtype); updates nothing in place. Returns
    ``(w, b, sqw, sqb, accw, accb, bw (2,), losses (T,))``, bw = (value, 1)."""
    base, lad = ladder(_mmd.bandwidth_multipliers())
    w, b, sqw, sqb, accw, accb = (t.clone() for t in (w, b, sqw, sqb, accw, accb))
    dev, dt = x3.device, x3.dtype
    bsp = round_up(bs, 64)
    mp = 2 * bsp
    lane = torch.arange(DP, device=dev)
    rowmask = (torch.arange(bsp, device=dev) < bs).to(dt)[:, None]
    dmask = (lane < d).to(dt)[None, :]
    lmask = (lane < latent).to(dt)[None, :]
    rid = torch.arange(mp, device=dev)[:, None]
    vrow = ((rid < bs) | ((rid >= bsp) & (rid < bsp + bs))).to(dt)
    xrow = (rid < bs).to(dt)
    q = xrow * vrow - (1.0 - xrow) * vrow
    inv = 1.0 / (bs * bs)
    thresh = torch.tensor(1.0 / d, dtype=dt)
    bw = torch.zeros((), dtype=dt, device=dev)
    losses = []
    for t, start in enumerate(np.asarray(starts).tolist()):
        batch = x3[start:start + bsp] * rowmask
        z = torch.zeros((bsp, LP), dtype=dt, device=dev)
        nz = noise[t, :bs, :latent]
        z[: nz.shape[0], : nz.shape[1]] = nz
        z = z * lmask * rowmask
        hs = [z]
        for layer in range(4):
            hs.append(hs[-1] @ w[layer] + b[layer][None, :])
        y_m = torch.where(lane[None, :] < d, hs[4], torch.full((), -1e30, dtype=dt, device=dev))
        e = torch.exp(y_m - torch.amax(y_m, dim=1, keepdim=True)) * dmask
        s = e / torch.sum(e, dim=1, keepdim=True)
        sel = s >= thresh
        u = torch.where(sel, torch.ones((), dtype=dt, device=dev), s) * dmask * rowmask
        zc = torch.cat([batch, u * batch])
        norms = torch.sum(zc * zc, dim=1, keepdim=True)
        if t == 0:
            m = 2.0 * bs
            mean = torch.sum(zc * vrow, dim=0, keepdim=True) / m
            zcc = (zc - mean) * vrow
            bw = 2.0 * m * torch.sum(zcc * zcc) / (m * m - m)
        d2 = torch.clamp_min(norms + norms.T - 2.0 * (zc @ zc.T), 0.0)
        cur = torch.exp(-d2 / (bw * base))
        kps = torch.zeros_like(cur)
        mmd_acc = torch.zeros((), dtype=dt, device=dev)
        prev = 1
        for power, mk in lad:
            while prev < power:
                cur = cur * cur
                prev *= 2
            mmd_acc = mmd_acc + torch.sum(cur * q * q.T)
            kps = kps + cur * (-1.0 / (bw * mk))
        # K'[q | q .* zc] over the masked rows only: the backward reads no other
        kpq = kps[bsp:] @ q
        kpqz = kps[bsp:] @ (q * zc)
        colmax = torch.amax(u, dim=0, keepdim=True)
        penalty = torch.sum(torch.where(lane[None, :] < d, 1.0 - colmax, 0.0)) / d
        losses.append(mmd_acc * inv + penalty_weight * penalty)

        dzc = 4.0 * inv * q[bsp:] * (kpq * zc[bsp:] - kpqz)
        du = dzc * batch
        eq = ((u == colmax) & (lane[None, :] < d)).to(dt) * rowmask
        cnt = torch.clamp_min(torch.sum(eq, dim=0, keepdim=True), 1.0)
        du = du - (penalty_weight / d) * eq / cnt
        ds = torch.where(sel, torch.zeros((), dtype=dt, device=dev), du) * dmask * rowmask
        dh = s * (ds - torch.sum(ds * s, dim=1, keepdim=True))
        for layer in (3, 2, 1, 0):
            dw = hs[layer].T @ dh
            db = torch.sum(dh, dim=0)
            if layer > 0:
                dh = dh @ w[layer].T
            for p, sq, acc, g in ((w[layer], sqw[layer], accw[layer], dw),
                                  (b[layer], sqb[layer], accb[layer], db)):
                g = g + weight_decay * p
                new_sq = RHO * sq + (1.0 - RHO) * g * g
                delta = g * torch.sqrt(acc + EPS) / torch.sqrt(new_sq + EPS)
                acc.copy_(RHO * acc + (1.0 - RHO) * delta * delta)
                sq.copy_(new_sq)
                p.copy_(p - lr * delta)
    losses = torch.stack(losses) if losses else torch.zeros((0,), dtype=dt, device=dev)
    bw_out = torch.stack([bw, torch.ones((), dtype=dt, device=dev)])
    return w, b, sqw, sqb, accw, accb, bw_out, losses


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


class _Ladder(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("base", ctypes.c_float),
        ("power", ctypes.c_int * _MAX_LADDER),
        ("mult", ctypes.c_float * _MAX_LADDER),
    ]


class _Hyper(ctypes.Structure):
    _fields_ = [
        ("d", ctypes.c_int), ("bs", ctypes.c_int),
        ("latent", ctypes.c_int), ("total_steps", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("lr", ctypes.c_float), ("weight_decay", ctypes.c_float),
        ("penalty_weight", ctypes.c_float), ("pw_over_d", ctypes.c_float),
        ("inv", ctypes.c_float), ("four_inv", ctypes.c_float),
        ("thresh", ctypes.c_float), ("bw_m2", ctypes.c_float), ("bw_den", ctypes.c_float),
    ]


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "vgan_fused_grid": [_P, _P],
    "vgan_fused_workspace_floats": [_I, _I],
    "vgan_fused_no_kl": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "vgan_philox_normal": [_P, _U, _I, _I, _I, _P],
}


def _lib():
    return _build.bound("fused_no_kl", _SIGNATURES)


def _grid(device) -> Tuple[int, int]:
    """``(blocks, barriers per step)`` of K8's cooperative launch on
    ``device``: one block per SM, or raises when the card cannot co-schedule
    them."""
    grid, barriers = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().vgan_fused_grid(ctypes.byref(grid), ctypes.byref(barriers))
    if rc != 0:
        raise RuntimeError(f"vgan_fused_grid: CUDA error {rc} (cooperative launch unsupported?)")
    return grid.value, barriers.value


def barriers_per_step(device) -> int:
    """Grid-wide barriers K8 takes per train step (one more at step 0)."""
    return _grid(device)[1]


def _hyper(d, bs, latent, total_steps, seed, lr, weight_decay, penalty_weight) -> _Hyper:
    m = 2.0 * bs
    return _Hyper(
        d=d, bs=bs, latent=latent, total_steps=total_steps, seed=int(seed),
        lr=lr, weight_decay=weight_decay, penalty_weight=penalty_weight,
        pw_over_d=penalty_weight / d, inv=1.0 / (bs * bs), four_inv=4.0 * (1.0 / (bs * bs)),
        thresh=1.0 / d, bw_m2=2.0 * m, bw_den=m * m - m,
    )


def _ladder_struct() -> _Ladder:
    """The default bandwidth ladder as K8 takes it."""
    base, lad = ladder(_mmd.bandwidth_multipliers())
    out = _Ladder(n=len(lad), base=base)
    for i, (power, mk) in enumerate(lad):
        out.power[i], out.mult[i] = power, mk
    return out


def fused_no_kl_fit_cuda(x3, starts, w, b, sqw, sqb, accw, accb, noise, seed: int, *, n: int,
                         d: int, bs: int, latent: int, lr: float, weight_decay: float,
                         penalty_weight: float, phase_ns: Optional[torch.Tensor] = None):
    """K8: every step of the fit in one cooperative launch. Same arguments
    and returns as :func:`fused_no_kl_fit_reference`, with ``starts`` an
    int32 device tensor, ``noise`` None (in-kernel Philox keyed by ``seed``)
    or a (T, BSP, LP) float32 device tensor, and the state packed in
    float32 on the card. ``phase_ns``, an int64 tensor of ``len(PHASES)``
    on the card, turns on the kernel's phase timer: it receives the
    nanoseconds of each phase over the fit (the fit's arithmetic is the
    same either way)."""
    dev = x3.device
    if phase_ns is not None and (not phase_ns.is_cuda or phase_ns.device != dev
                                 or phase_ns.dtype != torch.int64
                                 or tuple(phase_ns.shape) != (len(PHASES),)):
        raise ValueError(f"phase_ns: the phase timer takes an int64 tensor of shape "
                         f"({len(PHASES)},) on the fit's card, got {phase_ns.dtype} "
                         f"{tuple(phase_ns.shape)} on {phase_ns.device}")
    if dev.type != "cuda":
        raise ValueError(f"fused_no_kl_fit_cuda runs on the card, got tensors on {dev}")
    bsp = round_up(bs, 64)
    total_steps = int(starts.shape[0])
    check("x3", x3, (n + bsp, DP), dev)
    if starts.dtype != torch.int32 or not starts.is_contiguous() or starts.device != dev:
        raise ValueError("starts: expected a contiguous int32 tensor on the card")
    for name, t, shape in (("w", w, (4, WP, WP)), ("b", b, (8, WP)), ("sqw", sqw, (4, WP, WP)),
                           ("sqb", sqb, (8, WP)), ("accw", accw, (4, WP, WP)),
                           ("accb", accb, (8, WP))):
        check(name, t, shape, dev)
    if noise is not None:
        check("noise", noise, (total_steps, bsp, LP), dev)
    if not fused_supported(n, d, bs, latent):
        raise ValueError(f"fused path unsupported at n={n}, d={d}, bs={bs}, latent={latent}")
    lib = _lib()
    grid, _ = _grid(dev)
    work = torch.empty(lib.vgan_fused_workspace_floats(bs, grid), dtype=torch.float32, device=dev)
    out = [t.clone() for t in (w, b, sqw, sqb, accw, accb)]
    losses = torch.empty(total_steps, dtype=torch.float32, device=dev)
    bw = torch.zeros(2, dtype=torch.float32, device=dev)
    hyper = _hyper(d, bs, latent, total_steps, seed, lr, weight_decay, penalty_weight)
    launch(lib, "vgan_fused_no_kl", dev, x3.data_ptr(), starts.data_ptr(),
           noise.data_ptr() if noise is not None else None, *[t.data_ptr() for t in out],
           losses.data_ptr(), bw.data_ptr(), work.data_ptr(), ctypes.byref(hyper),
           ctypes.byref(_ladder_struct()), grid,
           phase_ns.data_ptr() if phase_ns is not None else None)
    _build.count("fused_no_kl_fit_cuda")
    return (*out, bw, losses)


def philox_normal(seed: int, steps: int, rows: int, lanes: int, device):
    """(steps, rows, lanes) float32: the standard normals K8 draws in rng
    mode for step s, batch row r and latent lane l (Box-Muller
    on two 24-bit uniforms of Philox4x32-10 keyed by (seed, step), counter
    (row, lane)), written by the kernel source's own generator."""
    out = torch.empty((steps, rows, lanes), dtype=torch.float32, device=device)
    launch(_lib(), "vgan_philox_normal", out.device, out.data_ptr(), int(seed), steps, rows, lanes)
    return out


def reset_launch_counts() -> None:
    _build.reset(["fused_no_kl_fit_cuda"])


def launch_counts() -> dict:
    return _build.counts(["fused_no_kl_fit_cuda"])


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def fused_no_kl_fit(x, generator, opt_state, config, epochs: int, seed: int,
                    noise: Optional[torch.Tensor] = None, offsets=None, perm=None):
    """Run ``epochs`` epochs of the no-kl fit from ``generator`` (a
    ``GeneratorBig``) and ``opt_state`` (its ``AdadeltaState``) in one go.

    ``x``: (n, d) tensor (or array, taken as a CPU tensor); a CUDA tensor
    runs K8, a CPU tensor the plain version. ``seed`` seeds the permutation,
    the offsets and the noise; ``noise`` (T, BSP, LP), ``offsets`` (epochs,)
    and ``perm`` (n,) inject them. Returns ``(params, (square_avg,
    acc_delta), (bw, bw_set), losses (epochs, nb), perm, offsets)``, the
    state dicts in the generator's ``main.{i}.{weight, bias}`` layout.
    Raises ``ValueError`` outside :func:`fused_supported`.
    """
    x = torch.as_tensor(x)
    dev = x.device
    n, d = x.shape
    bs = min(config.batch_size, n)
    latent = config.latent_size
    if not fused_supported(n, d, bs, latent):
        raise ValueError(f"fused path unsupported at n={n}, d={d}, bs={bs}, latent={latent}")
    nb = n // bs
    total_steps = epochs * nb
    bsp = round_up(bs, 64)
    dt = torch.float32 if dev.type == "cuda" else x.dtype
    if not dt.is_floating_point:
        dt = torch.float32
    params = {k: v.detach() for k, v in generator.state_dict().items()}
    g_perm, g_off, g_seed = streams(seed)
    if total_steps == 0:
        # mirror the scan path's clean no-op: no launch, the state as given
        offsets = (np.asarray(offsets, np.int32).reshape(epochs) if offsets is not None
                   else np.zeros((epochs,), np.int32))
        perm = (np.asarray(perm, np.int64) if perm is not None
                else torch.randperm(n, generator=g_perm).numpy())
        return (
            {k: v.clone() for k, v in params.items()},
            ({k: v.clone() for k, v in opt_state.square_avg.items()},
             {k: v.clone() for k, v in opt_state.acc_delta.items()}),
            (torch.zeros((), dtype=dt, device=dev), torch.zeros((), dtype=torch.bool, device=dev)),
            torch.zeros((epochs, nb), dtype=dt, device=dev),
            perm, offsets,
        )
    x3, starts, perm, offsets = schedule(x.detach().to(dt), bs, epochs, perm, offsets, g_perm,
                                         g_off)
    kernel_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=g_seed))
    w, b = pack_params(params, latent, d, dev, dt)
    sqw, sqb = pack_params(opt_state.square_avg, latent, d, dev, dt)
    accw, accb = pack_params(opt_state.acc_delta, latent, d, dev, dt)
    kw = dict(d=d, bs=bs, latent=latent, lr=config.lr_g, weight_decay=config.weight_decay,
              penalty_weight=config.penalty_weight)
    if noise is not None:
        noise = torch.as_tensor(noise).to(device=dev, dtype=dt)
        if noise.shape != (total_steps, bsp, LP):
            raise ValueError(f"noise: expected shape {(total_steps, bsp, LP)}, got {tuple(noise.shape)}")
    if dev.type == "cuda":
        starts_t = torch.from_numpy(starts.astype(np.int32)).to(dev)
        noise_t = noise.contiguous() if noise is not None else None
        out = fused_no_kl_fit_cuda(x3, starts_t, w, b, sqw, sqb, accw, accb, noise_t,
                                   kernel_seed, n=n, **kw)
    else:
        if noise is None:
            noise = torch.randn((total_steps, bs, latent), generator=g_seed).to(dt)
        out = fused_no_kl_fit_reference(x3, starts, w, b, sqw, sqb, accw, accb, noise, **kw)
    w, b, sqw, sqb, accw, accb, bw, losses = out
    return (
        unpack_params(w, b, latent, d),
        (unpack_params(sqw, sqb, latent, d), unpack_params(accw, accb, latent, d)),
        (bw[0], bw[1] > 0),
        losses.reshape(epochs, nb),
        perm, offsets,
    )
