"""Reads what the program's own training steps produce during the
set-up's first steps, which run through the window's own call
(``continue_fit``) on the same estimator: each step's loss (the scalar
that the step differentiates), each parameter's first gradient as the
optimizer is handed it (summed over the mesh, before the optimizer adds its
weight decay: with it, ``0.04 p`` outweighs the MMD's gradient in
Adadelta's state ``E[g^2]`` and hides it), and each parameter's change over
the first ``n_steps`` steps. It wraps the optimizer's step and
``torch.autograd.grad`` for that call only, and changes no value."""

from __future__ import annotations

import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


class StepRecorder:
    def __init__(self, n_steps: int = 3):
        self.n_steps = n_steps
        self.steps = 0
        self.losses = []
        self.grad_norms = None
        self.change_norms = None
        self._start = None

    def __enter__(self):
        from vgan_tpu_torch.train import adadelta

        self._cls = adadelta.Adadelta
        self._step = adadelta.Adadelta.step
        self._grad = torch.autograd.grad
        rec = self

        def grad(outputs, inputs, *args, **kwargs):
            if (rec.steps < rec.n_steps and isinstance(outputs, torch.Tensor)
                    and outputs.numel() == 1):
                rec.losses.append(float(outputs.detach()))
            return rec._grad(outputs, inputs, *args, **kwargs)

        def step(opt, params, grads, state, active=None):
            if rec.steps == 0:
                rec._start = {k: p.detach().clone() for k, p in params.items()}
            out = rec._step(opt, params, grads, state, active)
            rec.steps += 1
            if rec.steps == 1:
                rec.grad_norms = {k: _norm(g) for k, g in zip(params, grads)}
            if rec.steps == rec.n_steps:
                rec.change_norms = {k: _norm(p - rec._start[k]) for k, p in params.items()}
                rec._start = None
            return out

        torch.autograd.grad = grad
        self._cls.step = step
        return self

    def __exit__(self, *exc):
        torch.autograd.grad = self._grad
        self._cls.step = self._step
        self._start = None
        return False

    def readings(self) -> dict:
        return {"losses": self.losses[:self.n_steps], "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}


class OutputRecorder:
    """Keeps a host copy of what ``owner.name`` returns while it is
    entered (the set-up's calls read the per-subspace scores that the KNN
    kernel hands the ensemble, through the window's own entry)."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.outputs = owner, name, []

    def __enter__(self):
        self._fn = getattr(self.owner, self.name)
        rec = self

        def wrapped(*args, **kwargs):
            out = rec._fn(*args, **kwargs)
            rec.outputs.append(out.detach().cpu().numpy())
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._fn)
        return False
