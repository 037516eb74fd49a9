"""Plain reference of the first training steps of ``VGAN_no_kl`` and
``VGAN`` (the kernel-learning estimator), after the V-GAN reference
(jcribeiro98/V-GAN, ``src/vgan.py``, ``src/models/Generator.py``).

It works out again, from the run's seed, what the program draws from it:
the weights (drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
the generator's four layers first, then the detector's encoder and decoder,
each weight then bias), the training stream's seed (one
``torch.randint(0, 2**62)`` from the same generator) and, per epoch, from a
generator on the data's device seeded with it, the row permutation and the
(batches, batch, latent) noise. Then, in ``precision``:

- the generator: a purely linear L -> 2L -> 4L -> 8L -> d stack, then the
  upper softmax (softmax values >= 1/d snap to 1);
- the MMD^2: biased, five RBF kernels at 1/4 .. 4 times the bandwidth, the
  bandwidth ``sum_ij |z_i - z_j|^2 / (m^2 - m)`` of the first batch, then
  frozen; the no-kl loss adds 10 times the coverage penalty
  ``mean_j(1 - max_i U[i, j])``;
- the kl detector loss ``-(MMD(enc x, enc Ux) - 0.1 L2(x, dec x) - 0.1
  L2(Ux, dec Ux))``, the encoder and decoder purely linear, N(0, 0.1)
  weights and zero biases; the kl generator is detached (it never trains)
  and a generator epoch evaluates ``MMD(enc x, enc Ux)``;
- Adadelta (rho 0.9, eps 1e-6) with L2-coupled weight decay, as
  ``torch.optim.Adadelta``.

Parameters carry the names of the V-GAN reference's state dicts
(``main.{i}.weight``; ``encoder.main.{i}.bias``, ...). Readings, for the harness to compare with the program's: each step's loss,
each leaf's first gradient (as the optimizer is handed it, before its
weight decay), each leaf's change over the first three steps, and for kl the
first generator epoch's mean loss.
"""

from __future__ import annotations

import math

import torch

from reference.precision import dtype_of, mm

MULTS = (0.25, 0.5, 1.0, 2.0, 4.0)
RHO, EPS = 0.9, 1e-6


def latent_size(d: int) -> int:
    return max(int(d / 16), 1)


def _draw_stack(widths, scheme: str, g: torch.Generator):
    """(weight (out, in), bias) pairs in float32, drawn on the CPU."""
    layers = []
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        w = torch.empty(fan_out, fan_in)
        b = torch.empty(fan_out)
        if scheme == "uniform":  # torch's nn.Linear default: U(-1/sqrt(in), 1/sqrt(in))
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=g)
            b.uniform_(-bound, bound, generator=g)
        else:  # the reference's kl init hook: N(0, 0.1), zero bias
            w.normal_(0.0, 0.1, generator=g)
            b.zero_()
        layers.append((w, b))
    return layers


def draw_weights(d: int, seed: int, kl: bool):
    """``(generator, encoder, decoder, train_seed)``; the detector stacks are
    None for no-kl."""
    g = torch.Generator().manual_seed(int(seed))
    L = latent_size(d)
    scheme = "normal" if kl else "uniform"
    gen = _draw_stack([L, 2 * L, 4 * L, 8 * L, d], scheme, g)
    enc = dec = None
    if kl:
        enc = _draw_stack([d, 8 * L, 4 * L, 2 * L, L], scheme, g)
        dec = _draw_stack([L, 2 * L, 4 * L, 8 * L, d], scheme, g)
    train_seed = int(torch.randint(0, 2**62, (1,), generator=g))
    return gen, enc, dec, train_seed


def _leaves(prefix: str, stack, device, dtype):
    out = {}
    for i, (w, b) in enumerate(stack):
        out[f"{prefix}{i}.weight"] = w.to(device=device, dtype=dtype).requires_grad_(True)
        out[f"{prefix}{i}.bias"] = b.to(device=device, dtype=dtype).requires_grad_(True)
    return out


def linear_stack(params: dict, prefix: str, h: torch.Tensor, precision: str) -> torch.Tensor:
    i = 0
    while f"{prefix}{i}.weight" in params:
        h = mm(h, params[f"{prefix}{i}.weight"].T, precision) + params[f"{prefix}{i}.bias"]
        i += 1
    return h


def upper_softmax(h: torch.Tensor) -> torch.Tensor:
    s = torch.softmax(h, dim=-1)
    return torch.where(s >= 1.0 / h.shape[-1], torch.ones_like(s), s)


def candidate_bandwidth(z: torch.Tensor) -> torch.Tensor:
    m = z.shape[0]
    zc = z - z.mean(dim=0, keepdim=True)
    return (2.0 * m * torch.sum(zc * zc) / (m * m - m)).detach()


def mmd2(x: torch.Tensor, y: torch.Tensor, bw, precision: str):
    """``(biased MMD^2, bandwidth used)``; ``bw`` None takes this batch's."""
    n1 = x.shape[0]
    z = torch.cat([x, y], dim=0)
    if bw is None:
        bw = candidate_bandwidth(z)
    zn = torch.sum(z * z, dim=1)
    d2 = torch.clamp_min(zn[:, None] + zn[None, :] - 2.0 * mm(z, z.T, precision), 0.0)
    k = sum(torch.exp(-d2 / (bw * mk)) for mk in MULTS)
    return k[:n1, :n1].mean() - 2.0 * k[:n1, n1:].mean() + k[n1:, n1:].mean(), bw


def coverage(u: torch.Tensor) -> torch.Tensor:
    return torch.mean(1.0 - torch.amax(u, dim=0))


class Adadelta:
    def __init__(self, params: dict, lr: float, weight_decay: float):
        self.lr, self.wd = lr, weight_decay
        self.sq = {k: torch.zeros_like(p) for k, p in params.items()}
        self.acc = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        """Updates ``params`` in place."""
        for k, p in params.items():
            g = grads[k] + self.wd * p
            self.sq[k] = RHO * self.sq[k] + (1 - RHO) * g * g
            delta = g * torch.sqrt(self.acc[k] + EPS) / torch.sqrt(self.sq[k] + EPS)
            self.acc[k] = RHO * self.acc[k] + (1 - RHO) * delta * delta
            p.add_(-self.lr * delta)


def _epoch_draws(rng: torch.Generator, n: int, batch: int, L: int, device):
    perm = torch.randperm(n, generator=rng, device=device)
    nb = n // batch
    noise = torch.randn((nb, batch, L), generator=rng, dtype=torch.float32, device=device)
    return perm, noise


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tree.items()}


def follow(x: torch.Tensor, seed: int, cfg: dict, precision: str = "float64",
           n_steps: int = 3) -> dict:
    """The readings of the first ``n_steps`` training steps of the fit that
    ``cfg`` states (``kind`` 'no_kl' or 'kl', and ``params``), on the float32
    dataset ``x``, on the device the program ran on. kl runs the first
    detector epoch whole, then the first generator epoch."""
    kl = cfg["kind"] == "kl"
    p = cfg["params"]
    dtype = dtype_of(precision)
    device = x.device
    n, d = x.shape
    batch = min(int(p["batch_size"]), n)
    nb = n // batch
    L = latent_size(d)
    gen_w, enc_w, dec_w, train_seed = draw_weights(d, seed, kl)
    gen = _leaves("main.", gen_w, device, dtype)
    det = None
    if kl:
        det = {**_leaves("encoder.main.", enc_w, device, dtype),
               **_leaves("decoder.main.", dec_w, device, dtype)}
    del gen_w, enc_w, dec_w
    trained = det if kl else gen
    opt = Adadelta(trained, float(p["lr_D"] if kl else p["lr"]), float(p["weight_decay"]))
    start = {k: v.detach().clone() for k, v in trained.items()}
    rng = torch.Generator(device=device).manual_seed(train_seed)
    xd = x.to(dtype)
    keys = list(trained)
    out = {"losses": [], "grad_norms": None, "change_norms": None}
    bw = None
    perm, noise = _epoch_draws(rng, n, batch, L, device)
    for b in range(nb if kl else n_steps):
        rows = xd[perm[b * batch:(b + 1) * batch]]
        z = noise[b].to(dtype)
        with torch.no_grad():
            u = upper_softmax(linear_stack(gen, "main.", z, precision))
        with torch.enable_grad():
            if kl:
                ux = u * rows
                enc_x = linear_stack(det, "encoder.main.", rows, precision)
                enc_ux = linear_stack(det, "encoder.main.", ux, precision)
                dec_x = linear_stack(det, "decoder.main.", enc_x, precision)
                dec_ux = linear_stack(det, "decoder.main.", enc_ux, precision)
                mmd, bw = mmd2(enc_x, enc_ux, bw, precision)
                loss = -(mmd - 0.1 * torch.mean((rows - dec_x) ** 2)
                         - 0.1 * torch.mean((ux - dec_ux) ** 2))
            else:
                u = upper_softmax(linear_stack(gen, "main.", z, precision))
                mmd, bw = mmd2(rows, u * rows, bw, precision)
                loss = mmd + float(p.get("penalty_weight", 10.0)) * coverage(u)
            grads = dict(zip(keys, torch.autograd.grad(loss, [trained[k] for k in keys])))
        opt.step(trained, grads)
        if b < n_steps:
            out["losses"].append(float(loss.detach()))
        if b == 0:
            out["grad_norms"] = _norms(grads)
        if b == n_steps - 1:
            out["change_norms"] = _norms({k: trained[k].detach() - start[k] for k in keys})
    del start
    if kl:
        perm, noise = _epoch_draws(rng, n, batch, L, device)
        gen_losses = []
        with torch.no_grad():
            for b in range(nb):
                rows = xd[perm[b * batch:(b + 1) * batch]]
                u = upper_softmax(linear_stack(gen, "main.", noise[b].to(dtype), precision))
                mmd, _ = mmd2(linear_stack(det, "encoder.main.", rows, precision),
                              linear_stack(det, "encoder.main.", u * rows, precision), bw, precision)
                gen_losses.append(float(mmd))
        out["generator_epoch_loss"] = sum(gen_losses) / len(gen_losses)
    return out
