"""No-kl training steps (counterpart of ``vgan_tpu/train/steps.py``, no-kl half).

An epoch is: shuffle, drop-last batching, per-batch latent noise, then one
Adadelta step per batch on ``MMD(batch, U * batch) + 10 * coverage(U)`` with
``U = generator(noise)``. The bandwidth is frozen after the first batch:
``(bw_value, bw_is_set)`` are device tensors threaded through the state, so
no step reads anything back to the host. Per-epoch losses stay on the device
until the caller fetches them.

Randomness: ``rng=(perm, noise)`` injects an epoch's permutation and noise
(the lockstep tests hand both implementations the same numpy draws);
without it both come from the state's seeded ``torch.Generator``. The
state's generator module and optimizer state are updated in place (the JAX
package's states are immutable).

The kl variant, its detector and alternation schedule are not ported yet
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vgan_tpu_torch.models.generator import GeneratorBig, latent_size_for
from vgan_tpu_torch.models.initializers import REFERENCE_NORMAL, TORCH_DEFAULT
from vgan_tpu_torch.ops import mmd as mmd_ops
from vgan_tpu_torch.ops.activations import sample_gumbel
from vgan_tpu_torch.train.adadelta import Adadelta, AdadeltaState

GENERATOR_GRADS = ("reference", "st", "gumbel_st")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training configuration; fields and defaults as the JAX
    package's ``TrainConfig`` (``mmd_impl`` takes 'torch' for 'jnp' and
    'cuda' for 'pallas')."""

    ndims: int
    batch_size: int
    lr_g: float = 0.007
    lr_d: float = 0.007
    weight_decay: float = 0.04
    temperature: float = 0.0
    penalty_weight: float = 10.0
    iternum_d: int = 1
    iternum_g: int = 5
    freeze_bandwidth: bool = True
    replicate_encoder_freeze: bool = True
    replicate_generator_detach: bool = True
    elm: bool = False
    mmd_impl: str = "auto"
    gram_matmul_dtype: Optional[str] = None
    model_matmul_dtype: Optional[str] = None
    opt_state_dtype: Optional[str] = None
    init_scheme_kl: str = REFERENCE_NORMAL
    init_scheme_no_kl: str = TORCH_DEFAULT
    generator_grad: str = "reference"
    gumbel_tau: float = 1.0
    scan_unroll: int = 4
    latent_override: Optional[int] = None

    def __post_init__(self):
        if self.mmd_impl not in mmd_ops.IMPLS:
            raise ValueError(f"unknown mmd_impl {self.mmd_impl!r}; expected one of {mmd_ops.IMPLS}")
        if self.generator_grad not in GENERATOR_GRADS:
            raise ValueError(
                f"unknown generator_grad {self.generator_grad!r} "
                "(expected 'reference', 'st' or 'gumbel_st')"
            )
        for name in ("gram_matmul_dtype", "model_matmul_dtype", "opt_state_dtype"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: bf16 options are not "
                    "ported yet; see ROADMAP.md Queue 1, 'bf16 options'"
                )

    @property
    def latent_size(self) -> int:
        if self.latent_override is not None:
            return int(self.latent_override)
        return latent_size_for(self.ndims)

    def generator_module(
        self,
        kl: bool,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ) -> GeneratorBig:
        """Generator module (on the CPU); ``train=True`` applies
        ``generator_grad``. Sampling always uses ``GeneratorBig.sample``."""
        activation = "upper_softmax"
        if train and self.generator_grad != "reference":
            activation = self.generator_grad
        return GeneratorBig(
            out_features=self.ndims,
            latent_size=self.latent_size,
            init_scheme=self.init_scheme_kl if kl else self.init_scheme_no_kl,
            activation=activation,
            gumbel_tau=self.gumbel_tau,
            dtype=dtype,
            generator=generator,
        )

    def adadelta(self, lr: float) -> Adadelta:
        return Adadelta(lr, weight_decay=self.weight_decay, state_dtype=self.opt_state_dtype)


@dataclasses.dataclass
class NoKLTrainState:
    generator: GeneratorBig
    opt_state: AdadeltaState
    bw_value: torch.Tensor
    bw_is_set: torch.Tensor
    rng: torch.Generator


def _batches_from_perm(x: torch.Tensor, perm: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Drop-last batching of a ready permutation: (nb, batch_size, d)."""
    n = x.shape[0]
    if n < batch_size:
        raise ValueError(
            f"dataset has {n} rows < batch_size {batch_size}: drop-last "
            "batching would train zero batches (losses would be NaN)"
        )
    nb = n // batch_size
    return x[perm[: nb * batch_size]].reshape(nb, batch_size, x.shape[-1])


def init_no_kl_state(
    config: TrainConfig, seed: int, device, dtype: torch.dtype = torch.float32
) -> NoKLTrainState:
    """Generator (torch-default init), zero Adadelta state, unset bandwidth.

    The weights are drawn on the CPU from ``seed``, so they do not depend on
    the device; the training stream is a device generator seeded from the
    same CPU generator.
    """
    init_rng = torch.Generator().manual_seed(int(seed))
    gen = config.generator_module(kl=False, train=True, generator=init_rng, dtype=dtype)
    gen = gen.to(device)
    train_seed = int(torch.randint(0, 2**62, (1,), generator=init_rng))
    rng = torch.Generator(device=device).manual_seed(train_seed)
    params = dict(gen.named_parameters())
    return NoKLTrainState(
        generator=gen,
        opt_state=config.adadelta(config.lr_g).init(params),
        bw_value=torch.zeros((), dtype=dtype, device=device),
        bw_is_set=torch.zeros((), dtype=torch.bool, device=device),
        rng=rng,
    )


def _epoch_inputs(state: NoKLTrainState, x: torch.Tensor, config: TrainConfig, rng):
    n = x.shape[0]
    if rng is None:
        perm = torch.randperm(n, generator=state.rng, device=x.device)
        batches = _batches_from_perm(x, perm, config.batch_size)
        noise = torch.randn(
            (batches.shape[0], config.batch_size, config.latent_size),
            generator=state.rng, dtype=x.dtype, device=x.device,
        )
        return batches, noise, False
    perm, noise = rng
    perm = torch.as_tensor(perm, device=x.device).long()
    batches = _batches_from_perm(x, perm, config.batch_size)
    noise = torch.as_tensor(noise).to(device=x.device, dtype=x.dtype)
    return batches, noise, True


def no_kl_epoch(
    state: NoKLTrainState, x: torch.Tensor, config: TrainConfig, rng=None
) -> Tuple[NoKLTrainState, torch.Tensor]:
    """One no-kl epoch; returns ``(state, mean epoch loss)`` (a device
    scalar). ``rng``: optional injected ``(perm, noise)``, noise of shape
    (nb, batch_size, latent)."""
    gen = state.generator
    opt = config.adadelta(config.lr_g)
    batches, noise, injected = _epoch_inputs(state, x, config, rng)
    use_gumbel = config.generator_grad == "gumbel_st"
    if use_gumbel and injected:
        raise ValueError(
            "generator_grad='gumbel_st' cannot be combined with external "
            "noise injection (the lockstep paths use the reference estimator)"
        )
    params = dict(gen.named_parameters())
    bw_value, bw_is_set = state.bw_value, state.bw_is_set
    losses = []
    for b in range(batches.shape[0]):
        batch, z = batches[b], noise[b]
        gumbel = None
        if use_gumbel:
            gumbel = sample_gumbel(
                (config.batch_size, config.ndims), state.rng, x.dtype, x.device
            )
        with torch.enable_grad():
            u = gen(z, gumbel)
            loss, bw_used = mmd_ops.mmd_loss_constrained_stateful(
                batch,
                u * batch,
                u,
                weight=config.penalty_weight,
                bw_value=bw_value,
                bw_is_set=bw_is_set,
                impl=config.mmd_impl,
                matmul_dtype=config.gram_matmul_dtype,
            )
            grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(params, grads, state.opt_state)
        bw_value = bw_used.detach()
        if config.freeze_bandwidth:
            bw_is_set = torch.ones_like(bw_is_set)
        losses.append(loss.detach())
    state = dataclasses.replace(state, bw_value=bw_value, bw_is_set=bw_is_set)
    return state, torch.mean(torch.stack(losses))


def no_kl_train_epochs(
    state: NoKLTrainState, x: torch.Tensor, config: TrainConfig, epochs: int
) -> Tuple[NoKLTrainState, torch.Tensor]:
    """``epochs`` no-kl epochs; the (epochs,) loss history stays on device."""
    losses = []
    for _ in range(epochs):
        state, loss = no_kl_epoch(state, x, config)
        losses.append(loss)
    return state, torch.stack(losses)


def no_kl_fit_program(
    x: torch.Tensor, seed: int, config: TrainConfig, epochs: int
) -> Tuple[NoKLTrainState, torch.Tensor]:
    """The whole no-kl fit: init from ``seed``, then ``epochs`` epochs."""
    state = init_no_kl_state(config, seed, x.device, x.dtype)
    return no_kl_train_epochs(state, x, config, epochs)
