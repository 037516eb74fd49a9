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
        if state_dtype is not None:
            raise NotImplementedError(
                "opt_state_dtype other than None (bf16 Adadelta state) is not "
                "ported yet; see ROADMAP.md Queue 1, 'bf16 options'"
            )
        self.learning_rate = learning_rate
        self.rho = rho
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdadeltaState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdadeltaState(zeros, {k: torch.zeros_like(p) for k, p in params.items()})

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
            if not isinstance(a, torch.Tensor):
                sq.mul_(rho).add_((1.0 - rho) * g * g)
                delta = g * torch.sqrt(acc + eps) / torch.sqrt(sq + eps)
                acc.mul_(rho).add_((1.0 - rho) * delta * delta)
                p.add_(-lr * delta)
                continue
            new_sq = rho * sq + (1.0 - rho) * g * g
            delta = g * torch.sqrt(acc + eps) / torch.sqrt(new_sq + eps)
            new_acc = rho * acc + (1.0 - rho) * delta * delta
            p.add_(torch.where(a, -lr * delta, torch.zeros_like(delta)))
            sq.copy_(torch.where(a, new_sq, sq))
            acc.copy_(torch.where(a, new_acc, acc))
