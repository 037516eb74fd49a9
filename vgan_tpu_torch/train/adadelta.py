"""Adadelta with PyTorch's update rule, as a functional step on tensor dicts.

Counterpart of ``vgan_tpu.train.adadelta`` (the reference trains with
``torch.optim.Adadelta(lr, weight_decay)``, rho 0.9, eps 1e-6):

    g      <- grad + weight_decay * param          (L2-coupled)
    E[g^2] <- rho * E[g^2] + (1 - rho) * g^2
    delta  <- g * sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps)
    E[dx^2]<- rho * E[dx^2] + (1 - rho) * delta^2
    param  <- param + (-lr * delta)

written in the JAX package's operation order, so the two agree to the last
bit in float64. The state is explicit (it can be carried over from the JAX
package); parameters and state are updated in place.

``state_dtype='bfloat16'`` stores ``E[g^2]`` and ``E[dx^2]`` in bf16, as the
JAX package's option does: each update upcasts them to the parameter's
dtype, computes the new averages and ``delta`` there (``delta`` from the
unrounded new ``E[g^2]``), and rounds each average once, to nearest even,
when it is stored. A float32 state keeps the in-place update above.

Freezing: torch skips parameters whose ``grad`` is None (no update, no
weight decay, no state advance). ``step(..., active=...)`` reproduces that
per leaf. A leaf's flag may be a Python bool or a 0-dim bool tensor on the
device; a tensor flag is applied with ``torch.where``, as the JAX package
uses ``jnp.where``, so a flag that changes between phases of the kl fit
costs no host sync.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Union

import torch

from vgan_tpu_torch._dtypes import low_precision


class AdadeltaState(NamedTuple):
    square_avg: Dict[str, torch.Tensor]
    acc_delta: Dict[str, torch.Tensor]


class Adadelta:
    def __init__(
        self,
        learning_rate: float,
        rho: float = 0.9,
        eps: float = 1e-6,
        weight_decay: float = 0.0,
        state_dtype: Optional[str] = None,
    ):
        self.state_dtype = low_precision(state_dtype, "state_dtype")
        self.learning_rate = learning_rate
        self.rho = rho
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdadeltaState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
                    for k, p in params.items()}

        return AdadeltaState(zeros(), zeros())

    @torch.no_grad()
    def step(
        self,
        params: Dict[str, torch.Tensor],
        grads: Sequence[torch.Tensor],
        state: AdadeltaState,
        active: Optional[Mapping[str, Union[bool, torch.Tensor]]] = None,
    ) -> None:
        """One update of every parameter, in place; ``grads`` in the order
        of ``params``. ``active`` maps a parameter name to its step flag
        (missing names step)."""
        rho, eps, lr, wd = self.rho, self.eps, self.learning_rate, self.weight_decay
        for (name, p), g in zip(params.items(), grads):
            a = True if active is None else active.get(name, True)
            if not isinstance(a, torch.Tensor) and not a:
                continue
            sq, acc = state.square_avg[name], state.acc_delta[name]
            g = g + wd * p
            if not isinstance(a, torch.Tensor) and sq.dtype == p.dtype:
                sq.mul_(rho).add_((1.0 - rho) * g * g)
                delta = g * torch.sqrt(acc + eps) / torch.sqrt(sq + eps)
                acc.mul_(rho).add_((1.0 - rho) * delta * delta)
                p.add_(-lr * delta)
                continue
            # the math in the parameter's dtype; a bf16 state rounds once, in copy_
            sqm, accm = sq.to(p.dtype), acc.to(p.dtype)
            new_sq = rho * sqm + (1.0 - rho) * g * g
            delta = g * torch.sqrt(accm + eps) / torch.sqrt(new_sq + eps)
            new_acc = rho * accm + (1.0 - rho) * delta * delta
            upd = -lr * delta
            if isinstance(a, torch.Tensor):
                upd = torch.where(a, upd, torch.zeros_like(upd))
                new_sq, new_acc = torch.where(a, new_sq, sqm), torch.where(a, new_acc, accm)
            p.add_(upd)
            sq.copy_(new_sq)
            acc.copy_(new_acc)
