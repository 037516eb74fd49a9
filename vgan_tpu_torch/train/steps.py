"""Training steps and the alternation schedule (counterpart of
``vgan_tpu/train/steps.py``).

A no-kl epoch is: shuffle, drop-last batching, per-batch latent noise, then
one Adadelta step per batch on ``MMD(batch, U * batch) + 10 * coverage(U)``
with ``U = generator(noise)``. The kl variant alternates detector and
generator epochs (:class:`AlternationSchedule`) on the MMD between the
encodings of a batch and of its masked copy. The bandwidth is frozen after
the first batch:
``(bw_value, bw_is_set)`` are device tensors threaded through the state, so
no step reads anything back to the host. Per-epoch losses stay on the device
until the caller fetches them.

Every epoch takes a ``layout``: :data:`WHOLE` (the whole dataset and batch
on one device) or, over a mesh, :class:`vgan_tpu_torch.parallel.dp.MeshBatches`
(``x`` this rank's block; the networks run on this rank's rows of each
batch, the losses on the whole batch, the gradients summed over 'data').

Randomness: ``rng=(perm, noise)`` injects an epoch's permutation and noise
(the lockstep tests hand both implementations the same numpy draws);
without it both come from the state's seeded ``torch.Generator``. The
state's generator module and optimizer state are updated in place (the JAX
package's states are immutable).

:func:`train_state_to_payload` and :func:`train_state_from_payload` carry
either state through a checkpoint (``vgan_tpu_torch.utils.checkpoint``),
RNG state included, so a resumed fit continues bit for bit on the same
device.

Reference dynamics of the kl variant, each kept as in the JAX package:

- encoder freeze leak: a generator epoch freezes the whole detector, and the
  next detector epoch re-enables only the decoder, so the encoder stops
  learning after the first generator epoch (``encoder_active``, a device
  bool; ``replicate_encoder_freeze=False`` opts out; ``elm`` freezes the
  encoder from the start);
- frozen parameters take no Adadelta step, no weight decay and no state
  advance (the ``active`` flags of :class:`Adadelta`);
- the reference's kl generator never trains (torch ``Variable`` detaches):
  with ``replicate_generator_detach`` a generator epoch evaluates its loss
  under ``torch.no_grad()`` and updates nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vgan_tpu_torch.models.detector import Detector
from vgan_tpu_torch._dtypes import low_precision
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
    'cuda' for 'pallas'). The three bf16 options take None or 'bfloat16':
    ``gram_matmul_dtype`` rounds the MMD's distance operands
    (:mod:`vgan_tpu_torch.ops.mmd`), ``model_matmul_dtype`` runs the
    generator's and the detector's layers in bf16
    (:func:`~vgan_tpu_torch.models.generator.linear_stack`) and
    ``opt_state_dtype`` stores the Adadelta averages in bf16."""

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
            low_precision(getattr(self, name), name)

    @property
    def latent_size(self) -> int:
        if self.latent_override is not None:
            return int(self.latent_override)
        return latent_size_for(self.ndims)

    @property
    def _compute_dtype(self) -> Optional[torch.dtype]:
        return low_precision(self.model_matmul_dtype, "model_matmul_dtype")

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
            compute_dtype=self._compute_dtype,
        )

    def detector_module(
        self, generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32
    ) -> Detector:
        """Detector module (on the CPU), kl init."""
        return Detector(
            latent_size=self.latent_size,
            in_features=self.ndims,
            init_scheme=self.init_scheme_kl,
            dtype=dtype,
            generator=generator,
            compute_dtype=self._compute_dtype,
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


class WholeBatch:
    """The single-device layout of a training step: the whole dataset, batch
    and Gram on one device. Each hook is the identity of its counterpart in
    :class:`vgan_tpu_torch.parallel.dp.MeshBatches`, which splits a step
    over a mesh's 'data' ranks."""

    def n_rows(self, x: torch.Tensor) -> int:
        """Global row count of the dataset ``x`` holds."""
        return x.shape[0]

    def batch_source(self, x: torch.Tensor, perm: torch.Tensor, batch_size: int):
        """``b -> (batch_size, d)`` rows of batch ``b`` of the permutation."""
        return _batches_from_perm(x, perm, batch_size).__getitem__

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch-sized tensor."""
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch from every rank's rows (differentiable)."""
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the whole batch of a tensor of this rank's rows."""
        return torch.mean(t)

    def reduce_grads(self, grads):
        """The whole batch's gradients from this rank's contributions."""
        return grads


WHOLE = WholeBatch()


def _epoch_inputs(state, x: torch.Tensor, config: TrainConfig, rng, layout):
    """``(nb, batch_of, noise, injected)``: the batch count, the epoch's
    batches as a function of the batch index, the (nb, batch_size, latent)
    noise, and whether both were injected. The permutation runs over the
    global rows."""
    n = layout.n_rows(x)
    nb = n // config.batch_size
    if rng is None:
        perm = torch.randperm(n, generator=state.rng, device=x.device)
        batch_of = layout.batch_source(x, perm, config.batch_size)
        noise = torch.randn(
            (nb, config.batch_size, config.latent_size),
            generator=state.rng, dtype=x.dtype, device=x.device,
        )
        return nb, batch_of, noise, False
    perm, noise = rng
    perm = torch.as_tensor(perm, device=x.device).long()
    batch_of = layout.batch_source(x, perm, config.batch_size)
    noise = torch.as_tensor(noise).to(device=x.device, dtype=x.dtype)
    return nb, batch_of, noise, True


def _use_gumbel(config: TrainConfig, injected: bool) -> bool:
    use_gumbel = config.generator_grad == "gumbel_st"
    if use_gumbel and injected:
        raise ValueError(
            "generator_grad='gumbel_st' cannot be combined with external "
            "noise injection (the lockstep paths use the reference estimator)"
        )
    return use_gumbel


def _gumbel_noise(state, config: TrainConfig, x: torch.Tensor) -> torch.Tensor:
    return sample_gumbel((config.batch_size, config.ndims), state.rng, x.dtype, x.device)


def no_kl_epoch(
    state: NoKLTrainState, x: torch.Tensor, config: TrainConfig, rng=None, layout=WHOLE
) -> Tuple[NoKLTrainState, torch.Tensor]:
    """One no-kl epoch; returns ``(state, mean epoch loss)`` (a device
    scalar). ``rng``: optional injected ``(perm, noise)``, noise of shape
    (nb, batch_size, latent). ``layout``: :data:`WHOLE`, or a mesh's
    :class:`~vgan_tpu_torch.parallel.dp.MeshBatches` (``x`` then this rank's
    block): the generator runs on this rank's rows, the loss on the whole
    batch."""
    gen = state.generator
    opt = config.adadelta(config.lr_g)
    nb, batch_of, noise, injected = _epoch_inputs(state, x, config, rng, layout)
    use_gumbel = _use_gumbel(config, injected)
    params = dict(gen.named_parameters())
    bw_value, bw_is_set = state.bw_value, state.bw_is_set
    losses = []
    for b in range(nb):
        batch, z = batch_of(b), layout.rows(noise[b])
        gumbel = layout.rows(_gumbel_noise(state, config, x)) if use_gumbel else None
        with torch.enable_grad():
            u = layout.gather(gen(z, gumbel))
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
        opt.step(params, layout.reduce_grads(grads), state.opt_state)
        bw_value = bw_used.detach()
        if config.freeze_bandwidth:
            bw_is_set = torch.ones_like(bw_is_set)
        losses.append(loss.detach())
    state = dataclasses.replace(state, bw_value=bw_value, bw_is_set=bw_is_set)
    return state, torch.mean(torch.stack(losses))


def no_kl_train_epochs(
    state: NoKLTrainState, x: torch.Tensor, config: TrainConfig, epochs: int, layout=WHOLE
) -> Tuple[NoKLTrainState, torch.Tensor]:
    """``epochs`` no-kl epochs; the (epochs,) loss history stays on device."""
    losses = []
    for _ in range(epochs):
        state, loss = no_kl_epoch(state, x, config, layout=layout)
        losses.append(loss)
    return state, torch.stack(losses)


def no_kl_fit_program(
    x: torch.Tensor, seed: int, config: TrainConfig, epochs: int
) -> Tuple[NoKLTrainState, torch.Tensor]:
    """The whole no-kl fit: init from ``seed``, then ``epochs`` epochs."""
    state = init_no_kl_state(config, seed, x.device, x.dtype)
    return no_kl_train_epochs(state, x, config, epochs)


# ---------------------------------------------------------------------------
# kl variant: adversarial generator vs encoder/decoder detector
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KLTrainState:
    generator: GeneratorBig
    detector: Detector
    gen_opt: AdadeltaState
    det_opt: AdadeltaState
    bw_value: torch.Tensor
    bw_is_set: torch.Tensor
    encoder_active: torch.Tensor
    rng: torch.Generator


def init_kl_state(
    config: TrainConfig, seed: int, device, dtype: torch.dtype = torch.float32
) -> KLTrainState:
    """Generator and detector (kl init, N(0, 0.1) weights and zero biases),
    zero Adadelta states, unset bandwidth, encoder active unless ``elm``.
    Weights are drawn on the CPU from ``seed`` (generator first), the
    training stream is a device generator seeded from the same CPU stream."""
    init_rng = torch.Generator().manual_seed(int(seed))
    gen = config.generator_module(kl=True, train=True, generator=init_rng, dtype=dtype).to(device)
    det = config.detector_module(generator=init_rng, dtype=dtype).to(device)
    train_seed = int(torch.randint(0, 2**62, (1,), generator=init_rng))
    return KLTrainState(
        generator=gen,
        detector=det,
        gen_opt=config.adadelta(config.lr_g).init(dict(gen.named_parameters())),
        det_opt=config.adadelta(config.lr_d).init(dict(det.named_parameters())),
        bw_value=torch.zeros((), dtype=dtype, device=device),
        bw_is_set=torch.zeros((), dtype=torch.bool, device=device),
        encoder_active=torch.tensor(not config.elm, device=device),
        rng=torch.Generator(device=device).manual_seed(train_seed),
    )


def _detector_active_mask(det_params, encoder_active):
    """Per-parameter step flags: the decoder always steps; the encoder only
    while ``encoder_active`` (a device bool: no host sync)."""
    return {
        name: (encoder_active if name.startswith("encoder.") else True)
        for name in det_params
    }


def _kl_loss(det: Detector, batch, u, config: TrainConfig, bw_value, bw_is_set,
             with_reconstruction: bool, layout=WHOLE):
    """``MMD(enc x, enc Ux) + temperature * coverage(U)`` and, for the
    detector, ``-(that - 0.1 L2(x, dec x) - 0.1 L2(Ux, dec Ux))``, L2 the
    reference's ``__distance(..., 'L2')`` (the mean squared difference).
    Without the reconstruction terms only the encoder runs. ``batch`` and
    ``u`` are this rank's rows; the MMD, the coverage and the means are the
    whole batch's."""
    ux = u * batch
    if with_reconstruction:
        (enc_x, dec_x), (enc_ux, dec_ux) = det(batch), det(ux)
    else:
        enc_x, enc_ux = det.encoder(batch), det.encoder(ux)
    mmd, bw = mmd_ops.mmd_loss_constrained_stateful(
        layout.gather(enc_x),
        layout.gather(enc_ux),
        layout.gather(u),
        weight=config.temperature,
        bw_value=bw_value,
        bw_is_set=bw_is_set,
        impl=config.mmd_impl,
        matmul_dtype=config.gram_matmul_dtype,
    )
    if not with_reconstruction:
        return mmd, bw
    l2_x = layout.mean((batch - dec_x) ** 2)
    l2_ux = layout.mean((ux - dec_ux) ** 2)
    return -(mmd - 0.1 * l2_x - 0.1 * l2_ux), bw


def kl_detector_epoch(
    state: KLTrainState, x: torch.Tensor, config: TrainConfig, rng=None, layout=WHOLE
) -> Tuple[KLTrainState, torch.Tensor]:
    """One detector epoch: per batch, ``U = G(z)`` detached, then one
    Adadelta step of the detector on ``-(MMD(enc x, enc Ux) - 0.1 L2(x,
    dec x) - 0.1 L2(Ux, dec Ux))``; the encoder steps only while active.
    Returns ``(state, mean epoch loss)``; ``rng`` and ``layout`` as in
    :func:`no_kl_epoch` (the generator and the detector run on this rank's
    rows)."""
    gen, det = state.generator, state.detector
    opt = config.adadelta(config.lr_d)
    nb, batch_of, noise, injected = _epoch_inputs(state, x, config, rng, layout)
    use_gumbel = _use_gumbel(config, injected)
    encoder_active = state.encoder_active
    if not config.replicate_encoder_freeze:
        encoder_active = torch.ones_like(encoder_active)
    if config.elm:
        # the reference's __elm freezes the encoder whatever the quirk flag
        encoder_active = torch.zeros_like(encoder_active)
    params = dict(det.named_parameters())
    active = _detector_active_mask(params, encoder_active)
    bw_value, bw_is_set = state.bw_value, state.bw_is_set
    losses = []
    for b in range(nb):
        batch, z = layout.rows(batch_of(b)), layout.rows(noise[b])
        gumbel = layout.rows(_gumbel_noise(state, config, x)) if use_gumbel else None
        with torch.no_grad():
            u = gen(z, gumbel)
        with torch.enable_grad():
            loss, bw_used = _kl_loss(det, batch, u, config, bw_value, bw_is_set, True, layout)
            grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(params, layout.reduce_grads(grads), state.det_opt, active=active)
        bw_value = bw_used.detach()
        if config.freeze_bandwidth:
            bw_is_set = torch.ones_like(bw_is_set)
        losses.append(loss.detach())
    state = dataclasses.replace(state, bw_value=bw_value, bw_is_set=bw_is_set)
    return state, torch.mean(torch.stack(losses))


def kl_generator_epoch(
    state: KLTrainState, x: torch.Tensor, config: TrainConfig, rng=None, layout=WHOLE
) -> Tuple[KLTrainState, torch.Tensor]:
    """One generator epoch on ``MMD(enc x, enc Ux) + temperature *
    coverage(U)`` with the detector frozen. Under
    ``replicate_generator_detach`` the loss is only evaluated, under
    ``torch.no_grad()`` (the bandwidth state still advances); otherwise the
    generator takes one Adadelta step per batch. Afterwards the encoder is
    inactive (the reference's freeze leak)."""
    gen, det = state.generator, state.detector
    opt = config.adadelta(config.lr_g)
    nb, batch_of, noise, injected = _epoch_inputs(state, x, config, rng, layout)
    use_gumbel = _use_gumbel(config, injected)
    params = dict(gen.named_parameters())
    bw_value, bw_is_set = state.bw_value, state.bw_is_set
    losses = []
    for b in range(nb):
        batch, z = layout.rows(batch_of(b)), layout.rows(noise[b])
        gumbel = layout.rows(_gumbel_noise(state, config, x)) if use_gumbel else None
        if config.replicate_generator_detach:
            with torch.no_grad():
                loss, bw_used = _kl_loss(det, batch, gen(z, gumbel), config,
                                         bw_value, bw_is_set, False, layout)
        else:
            with torch.enable_grad():
                loss, bw_used = _kl_loss(det, batch, gen(z, gumbel), config,
                                         bw_value, bw_is_set, False, layout)
                grads = torch.autograd.grad(loss, list(params.values()))
            opt.step(params, layout.reduce_grads(grads), state.gen_opt)
        bw_value = bw_used.detach()
        if config.freeze_bandwidth:
            bw_is_set = torch.ones_like(bw_is_set)
        losses.append(loss.detach())
    state = dataclasses.replace(
        state, bw_value=bw_value, bw_is_set=bw_is_set,
        encoder_active=torch.zeros_like(state.encoder_active),
    )
    return state, torch.mean(torch.stack(losses))


PHASE_DETECTOR, PHASE_GENERATOR, PHASE_IDLE = 0, 1, 2


def kl_train_epochs(
    state: KLTrainState, x: torch.Tensor, phases, config: TrainConfig, layout=WHOLE
) -> Tuple[KLTrainState, torch.Tensor, torch.Tensor]:
    """Run the epochs ``phases`` names (host ints: 0 detector, 1 generator,
    2 idle, from :class:`AlternationSchedule`). Returns ``(state,
    detector_history, generator_history)``, float32 device tensors of shape
    (epochs,): each epoch records the most recent loss of each kind, NaN
    before the first epoch of that kind."""
    nan = torch.full((), float("nan"), dtype=torch.float32, device=x.device)
    last_det, last_gen = nan, nan
    det_hist, gen_hist = [], []
    for phase in np.asarray(phases).tolist():
        if phase == PHASE_DETECTOR:
            state, loss = kl_detector_epoch(state, x, config, layout=layout)
            last_det = loss.to(torch.float32)
        elif phase == PHASE_GENERATOR:
            state, loss = kl_generator_epoch(state, x, config, layout=layout)
            last_gen = loss.to(torch.float32)
        elif phase != PHASE_IDLE:
            raise ValueError(f"unknown phase code {phase}")
        det_hist.append(last_det)
        gen_hist.append(last_gen)
    if not det_hist:
        empty = torch.zeros((0,), dtype=torch.float32, device=x.device)
        return state, empty, empty
    return state, torch.stack(det_hist), torch.stack(gen_hist)


def kl_fit_program(
    x: torch.Tensor, seed: int, phases, config: TrainConfig
) -> Tuple[KLTrainState, torch.Tensor, torch.Tensor]:
    """The whole kl fit: init from ``seed``, then the phased epochs."""
    state = init_kl_state(config, seed, x.device, x.dtype)
    return kl_train_epochs(state, x, phases, config)


class AlternationSchedule:
    """The reference's epoch-phase counters: detector epochs while
    ``iternum_d`` allows, then generator epochs while ``iternum_g`` allows;
    finishing the generator run resets the detector counter. The defaults
    (1, 5) give one detector epoch, then five generator epochs."""

    DETECTOR = "detector"
    GENERATOR = "generator"
    IDLE = "idle"

    def __init__(self, iternum_d: int, iternum_g: int):
        self.iternum_d = iternum_d
        self.iternum_g = iternum_g
        self._d = 1
        self._g = 1

    def next_phase(self) -> str:
        if self._d <= self.iternum_d:
            self._d += 1
            self._g = 1
            return self.DETECTOR
        if self._g <= self.iternum_g:
            self._g += 1
            if self._g > self.iternum_g:
                self._d = 1
            return self.GENERATOR
        return self.IDLE

    def phase_array(self, epochs: int) -> np.ndarray:
        """Phase codes for the next ``epochs`` epochs."""
        codes = {self.DETECTOR: PHASE_DETECTOR, self.GENERATOR: PHASE_GENERATOR,
                 self.IDLE: PHASE_IDLE}
        return np.asarray([codes[self.next_phase()] for _ in range(epochs)], dtype=np.int32)

    def get_state(self) -> dict:
        """Counter snapshot for checkpoint metadata."""
        return {"d": self._d, "g": self._g}

    def set_state(self, state: dict) -> None:
        self._d = state["d"]
        self._g = state["g"]


# ---------------------------------------------------------------------------
# train-state (de)serialisation for checkpoints
# ---------------------------------------------------------------------------


def _cpu(tree: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def _load_(dst: dict, src: dict) -> None:
    for k, v in dst.items():
        v.copy_(src[k])


def train_state_to_payload(state) -> dict:
    """A ``NoKLTrainState`` or ``KLTrainState`` as CPU tensors and dicts
    (``torch.save``-able with ``weights_only`` loading): module state dicts,
    Adadelta dicts, the bandwidth, its flag, the encoder flag and the
    training generator's RNG state."""
    payload = {
        "device_type": state.bw_value.device.type,
        "bw_value": state.bw_value.detach().cpu(),
        "bw_is_set": state.bw_is_set.detach().cpu(),
        "rng": state.rng.get_state(),
        "generator": _cpu(state.generator.state_dict()),
    }
    if isinstance(state, KLTrainState):
        payload.update(
            kind="kl",
            detector=_cpu(state.detector.state_dict()),
            gen_opt=[_cpu(state.gen_opt.square_avg), _cpu(state.gen_opt.acc_delta)],
            det_opt=[_cpu(state.det_opt.square_avg), _cpu(state.det_opt.acc_delta)],
            encoder_active=state.encoder_active.detach().cpu(),
        )
    else:
        payload.update(kind="no_kl",
                       opt=[_cpu(state.opt_state.square_avg), _cpu(state.opt_state.acc_delta)])
    return payload


def train_state_from_payload(payload: dict, config: TrainConfig, device):
    """Rebuild a train state on ``device`` from :func:`train_state_to_payload`'s
    output. The RNG state only fits a generator of the device type it was
    saved from; another device type raises ``ValueError``."""
    device = torch.device(device)
    if payload["device_type"] != device.type:
        raise ValueError(
            f"checkpoint was written on a {payload['device_type']} device; its random "
            f"stream cannot resume on {device.type} (restore on the same device type)"
        )
    kl = payload["kind"] == "kl"
    state = (init_kl_state if kl else init_no_kl_state)(config, 0, device)
    state.generator.load_state_dict(payload["generator"])
    state.rng.set_state(payload["rng"])
    state.bw_value = payload["bw_value"].to(device)
    state.bw_is_set = payload["bw_is_set"].to(device)
    if kl:
        state.detector.load_state_dict(payload["detector"])
        for opt, (sq, acc) in ((state.gen_opt, payload["gen_opt"]),
                               (state.det_opt, payload["det_opt"])):
            _load_(opt.square_avg, sq)
            _load_(opt.acc_delta, acc)
        state.encoder_active = payload["encoder_active"].to(device)
    else:
        _load_(state.opt_state.square_avg, payload["opt"][0])
        _load_(state.opt_state.acc_delta, payload["opt"][1])
    return state
