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
JAX package's option does: each update reads them into the parameter's
dtype, computes the new averages and ``delta`` there (``delta`` from the
unrounded new ``E[g^2]``), and rounds each average once, to nearest even,
when it is stored.

Freezing: torch skips parameters whose ``grad`` is None (no update, no
weight decay, no state advance). ``step(..., active=...)`` reproduces that
per leaf. A leaf's flag may be a Python bool or a 0-dim bool tensor on the
device; a tensor flag is read where the update runs, as the JAX package
uses ``jnp.where``, so a flag that changes between phases of the kl fit
costs no host sync.

The update itself is ``ops/cuda/adadelta.py``'s: float32 parameters on a
CUDA card go to one multi-tensor kernel launch a step (a frozen leaf's
blocks return on the card), the rest to its plain PyTorch version.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Union

import torch

from vgan_tpu_torch._dtypes import low_precision
from vgan_tpu_torch.ops.cuda import adadelta as _update


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
        leaves = []
        for (name, p), g in zip(params.items(), grads):
            flag = True if active is None else active.get(name, True)
            if not isinstance(flag, torch.Tensor):
                flag = bool(flag)
            leaves.append((p, g, state.square_avg[name], state.acc_delta[name], flag))
        _update.update(leaves, self.rho, self.eps, self.learning_rate, self.weight_decay)
