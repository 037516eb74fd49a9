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
package); parameters and state are updated in place. The per-leaf
``active`` freeze mask is needed only by the kl variant, not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

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
    ) -> None:
        """One update of every parameter, in place; ``grads`` in the order
        of ``params``."""
        rho, eps, lr, wd = self.rho, self.eps, self.learning_rate, self.weight_decay
        for (name, p), g in zip(params.items(), grads):
            sq, acc = state.square_avg[name], state.acc_delta[name]
            g = g + wd * p
            sq.mul_(rho).add_((1.0 - rho) * g * g)
            delta = g * torch.sqrt(acc + eps) / torch.sqrt(sq + eps)
            acc.mul_(rho).add_((1.0 - rho) * delta * delta)
            p.add_(-lr * delta)
