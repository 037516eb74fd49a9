"""The ``VGAN`` and ``VGAN_no_kl`` estimators (counterpart of ``vgan_tpu.api.vgan``).

Same constructor names and defaults, same workflow: ``fit`` ->
``generate_subspaces`` -> ``approx_subspace_dist`` -> ``check_if_myopic``,
plus ``model_snapshot``, ``load_models``, ``get_params``,
``get_the_networks`` and ``train_history``. It runs on ``cuda`` unless
given ``device="cpu"``.

Reference quirks kept, as in the JAX package (``replicate_reference_quirks``):

- ``VGAN.__init__`` hard-codes ``seed = 777`` whatever the argument;
- the reference's kl generator never trains (torch ``Variable`` detaches);
  ``replicate_generator_detach`` (default: the quirks flag) keeps that;
- the encoder stops learning after the first generator epoch (see
  :mod:`vgan_tpu_torch.train.steps`);
- ``generate_subspaces`` re-seeds from ``self.seed`` on every call, so its
  output is deterministic per (seed, nsubs);
- ``approx_subspace_dist(add_leftover_features=True)`` appends the
  never-selected-features mask with weight 1 after normalizing, then
  renormalizes;
- ``check_if_myopic`` passes the divisor-style recommended bandwidth
  directly as the multiplier-style kernel alpha.

Random streams are torch's, not JAX's: the same seed gives other masks than
``vgan_tpu``. The tests hold the two together by injecting the streams.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device
from vgan_tpu_torch.api.base import EstimatorBase
from vgan_tpu_torch.models.generator import GeneratorBig, latent_size_for
from vgan_tpu_torch.ops.activations import binarize_mask
from vgan_tpu_torch.ops.mmd import candidate_bandwidth
from vgan_tpu_torch.ops.mmd_test import (
    mmd_permutation_test_sweep,
    mmd_permutation_test_sweep_precise,
)
from vgan_tpu_torch.train.steps import (
    AlternationSchedule,
    TrainConfig,
    init_kl_state,
    init_no_kl_state,
    kl_train_epochs,
    no_kl_train_epochs,
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md Queue 1")


def _column_l2_normalize(x: np.ndarray) -> np.ndarray:
    """sklearn ``normalize(x, axis=0)``: each column scaled to unit L2 norm."""
    norms = np.linalg.norm(x, axis=0)
    norms = np.where(norms == 0.0, 1.0, norms)
    return x / norms


class _VGANCommon(EstimatorBase):
    """Behaviour shared by the reference's two estimator classes."""

    _kl: bool

    # -- inference path -----------------------------------------------------

    def _masks_from_noise(self, z: torch.Tensor) -> np.ndarray:
        """Binary masks ``u >= 1/d`` of the upper-softmax generator at ``z``."""
        with torch.no_grad():
            z = z.to(device=self.device, dtype=next(self.generator.parameters()).dtype)
            return binarize_mask(self.generator.sample(z), axis=-1).cpu().numpy()

    def generate_subspaces(self, nsubs: int) -> np.ndarray:
        """``nsubs`` binary subspace masks (nsubs, d), re-seeded from
        ``self.seed`` on every call. The noise is drawn on the CPU, so the
        masks do not depend on the device."""
        seed = self.seed if self.seed is not None else int(np.random.randint(0, 2**31 - 1))
        g = torch.Generator().manual_seed(int(seed))
        z = torch.randn((nsubs, self._latent_size), generator=g, dtype=torch.float32)
        return self._masks_from_noise(z)

    def approx_subspace_dist(self, subspace_count: int = 500, add_leftover_features: bool = False):
        """Empirical distribution over the unique sampled masks."""
        u = self.generate_subspaces(subspace_count)
        unique_subspaces, proba = np.unique(u, axis=0, return_counts=True)
        if (unique_subspaces.sum(axis=0) < 1).sum() != 0 and add_leftover_features:
            unique_subspaces = np.append(
                unique_subspaces, [unique_subspaces.sum(axis=0) < 1], axis=0
            )
            proba = np.append(proba / proba.sum(), 1)
        self.subspaces = unique_subspaces
        self.proba = proba / proba.sum()

    def check_if_myopic(
        self,
        x_data: np.ndarray,
        bandwidth: Union[float, list, np.ndarray] = 0.01,
        count: int = 500,
        n_permutations: int = 1000,
        rng: Optional[np.random.Generator] = None,
        precision: str = "float64",
    ):
        """MMD goodness-of-fit test for myopicity; a 1 x (k+1) DataFrame of
        p-values.

        Column-L2-normalizes the data, samples ``count`` rows, projects each
        through a sampled mask with mean imputation of the dropped
        features, then runs the permutation test at each bandwidth plus the
        recommended one, each passed as a kernel alpha. 'float64' is the
        precise path (valid near the null): host float64 up to 16384 pooled
        rows, past that the streaming-Gram kernel on this estimator's device
        with a float64 reduction. 'float32' is the device sweep (screening
        only), through the kernel past 8192 pooled rows.
        """
        import pandas as pd

        if precision not in ("float64", "float32"):
            raise ValueError(f"precision must be 'float64' or 'float32', got {precision!r}")
        x_sample, ux_sample = self._gof_samples(x_data, count, rng)

        if getattr(self, "bandwidth", None) is None:
            pooled = torch.from_numpy(np.concatenate([x_sample, ux_sample]))
            self.bandwidth = float(candidate_bandwidth(pooled))

        if isinstance(bandwidth, float):
            bandwidth = [bandwidth]
        bandwidth = [float(b) for b in np.asarray(bandwidth).ravel()]
        bandwidth.sort()
        alphas = bandwidth + [float(self.bandwidth)]
        seed = self.seed if self.seed is not None else 0
        if precision == "float64":
            _, pvals = mmd_permutation_test_sweep_precise(
                x_sample, ux_sample, alphas=alphas,
                rng=np.random.default_rng(seed), n_permutations=n_permutations,
                device=self.device,
            )
        else:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            _, pvals = mmd_permutation_test_sweep(
                torch.from_numpy(x_sample), torch.from_numpy(ux_sample),
                alphas=alphas, generator=g, n_permutations=n_permutations,
                device=self.device,
            )
            pvals = pvals.cpu().numpy()
        results = [float(p) for p in np.asarray(pvals)]
        columns = bandwidth + ["recommended bandwidth"]
        return pd.DataFrame([results], columns=columns, index=["p-val"])

    def _gof_samples(self, x_data, count: int, rng: Optional[np.random.Generator]):
        """The two samples of :meth:`check_if_myopic`: ``count`` rows of the
        column-L2-normalized data (drawn with ``rng``, unseeded when None, as
        the reference) and their masked copies with mean imputation."""
        if count > x_data.shape[0]:
            raise ValueError(
                "Selected 'count' is greater than the number of samples in the dataset"
            )
        rng = rng or np.random.default_rng()
        x_norm = _column_l2_normalize(np.asarray(x_data, dtype=np.float64))
        idx = rng.choice(x_norm.shape[0], size=count, replace=False)
        x_sample = x_norm[idx].astype(np.float32)
        u = self.generate_subspaces(count)
        col_mean = x_sample.mean(axis=0)
        return x_sample, u * x_sample + col_mean * (~u)

    # -- persistence --------------------------------------------------------

    def load_models(self, path_to_generator, ndims: int, device: str = None):
        """Load a trained generator (a reference-layout ``.pt``) for
        sampling, onto ``device`` (default: this estimator's device)."""
        if device is not None:
            self.device = resolve_device(device)
        self._latent_size = latent_size_for(ndims)
        self._ndims = ndims
        self._config = self._make_config(ndims, self.batch_size)
        state = self._load_state_dict(path_to_generator)
        module = self._config.generator_module(kl=self._kl)
        module.load_state_dict(state)
        self.generator = module.to(self.device)
        self.generator_optimizer = (
            f"Loaded Model from {path_to_generator} with {ndims} dimensions in the latent space"
        )

    def save_checkpoint(self, path):
        raise _not_ported("save_checkpoint (utils/checkpoint.py)")

    def restore_checkpoint(self, path):
        raise _not_ported("restore_checkpoint (utils/checkpoint.py)")

    def continue_fit(self, X, epochs: int):
        raise _not_ported("continue_fit (resume from a checkpointed train state)")

    # -- fit helpers --------------------------------------------------------

    def _prepare_fit_config(self, X):
        """Validate the input, clamp the batch size, build the config."""
        X = np.asarray(X)
        if X.ndim != 2 or 0 in X.shape:
            raise ValueError(
                "X must be a non-empty 2-D array (n_samples, n_features); "
                f"got shape {X.shape}"
            )
        if X.dtype == np.bool_:
            X = X.astype(np.float32)
        if not np.issubdtype(X.dtype, np.number) or np.issubdtype(X.dtype, np.complexfloating):
            raise ValueError(f"X must be real-numeric; got dtype {X.dtype}")
        if not np.isfinite(X).all():
            raise ValueError(
                "X contains NaN/Inf entries; the MMD Gram propagates a "
                "single non-finite value into the whole loss - clean or "
                "impute the data before fit()"
            )
        self.batch_size = min(self.batch_size, X.shape[0])
        self._ndims = X.shape[1]
        self._config = config = self._make_config(self._ndims, self.batch_size)
        self._latent_size = config.latent_size
        return X, config

    def _persist_artifacts(self, save_detector: bool):
        if self.path_to_directory is None:
            return
        path = Path(self.path_to_directory)
        models_dir = path / "models"
        run_number = self._count_runs(models_dir)
        self._save_generator(models_dir, run_number, self.generator)
        if save_detector:
            self._save_detector(models_dir, run_number, self.detector)
        self.model_snapshot(path, run_number, show=False)


def _reject_left_out(mesh, shard_features, checkpoint_dir, checkpoint_every, **dtypes) -> None:
    if mesh is not None or shard_features:
        raise _not_ported("mesh / shard_features (multi-device fit, parallel/)")
    if checkpoint_dir is not None or checkpoint_every is not None:
        raise _not_ported("checkpoint_dir / checkpoint_every (utils/checkpoint.py)")
    for name, value in dtypes.items():
        if value is not None:
            raise _not_ported(f"{name}={value!r} (bf16 options)")


class VGAN(_VGANCommon):
    """Subspace generation with kernel learning: a generator trained
    adversarially against an encoder/decoder detector. The detector
    maximizes the multi-bandwidth RBF MMD between the encodings of a batch
    and of its masked copy, minus reconstruction penalties; the generator
    minimizes that MMD."""

    def __init__(
        self,
        batch_size: int = 500,
        temperature: float = 0,
        epochs: int = 2000,
        lr_G: float = 0.007,
        lr_D: float = 0.007,
        iternum_d: int = 1,
        iternum_g: int = 5,
        momentum: float = 0.99,
        seed: int = 777,
        weight_decay: float = 0.04,
        path_to_directory=None,
        *,
        mmd_impl: str = "auto",
        replicate_reference_quirks: bool = True,
        replicate_generator_detach: Optional[bool] = None,
        generator_grad: str = "reference",
        gumbel_tau: float = 1.0,
        latent_size: Optional[int] = None,
        elm: bool = False,
        verbose: bool = True,
        mesh=None,
        shard_features: bool = False,
        gram_matmul_dtype=None,
        model_matmul_dtype=None,
        opt_state_dtype=None,
        checkpoint_dir=None,
        checkpoint_every: int = None,
        device=None,
    ):
        super().__init__(path_to_directory)
        _reject_left_out(mesh, shard_features, checkpoint_dir, checkpoint_every,
                         gram_matmul_dtype=gram_matmul_dtype,
                         model_matmul_dtype=model_matmul_dtype,
                         opt_state_dtype=opt_state_dtype)
        self.device = resolve_device(device)
        self.storage = dict(
            batch_size=batch_size, temperature=temperature, epochs=epochs,
            lr_G=lr_G, lr_D=lr_D, iternum_d=iternum_d, iternum_g=iternum_g,
            momentum=momentum, seed=seed, weight_decay=weight_decay,
            path_to_directory=path_to_directory,
        )
        self._kl = True
        self.mesh = None
        self.shard_features = False
        self.checkpoint_dir = None
        self.checkpoint_every = None
        self.gram_matmul_dtype = None
        self.model_matmul_dtype = None
        self.opt_state_dtype = None
        self.batch_size = batch_size
        self.temperature = temperature
        self.epochs = epochs
        self.lr_G = lr_G
        self.lr_D = lr_D
        self.iternum_d = iternum_d
        self.iternum_g = iternum_g
        self.momentum = momentum  # stored, never applied (reference parity)
        self.weight_decay = weight_decay
        self.mmd_impl = mmd_impl
        self.replicate_reference_quirks = replicate_reference_quirks
        self.replicate_generator_detach = (
            replicate_reference_quirks
            if replicate_generator_detach is None
            else replicate_generator_detach
        )
        self.elm = elm  # the reference's private __elm flag
        self.generator_grad = generator_grad
        self.gumbel_tau = gumbel_tau
        self.latent_size = latent_size
        self.verbose = verbose
        self.bandwidth = None
        # reference quirk: the seed is hard-coded to 777
        self.seed = 777 if replicate_reference_quirks else seed

    @property
    def _lr_g(self):
        return self.lr_G

    def _make_config(self, ndims: int, batch_size: int) -> TrainConfig:
        return TrainConfig(
            ndims=ndims,
            batch_size=batch_size,
            lr_g=self.lr_G,
            lr_d=self.lr_D,
            weight_decay=self.weight_decay,
            temperature=self.temperature,
            iternum_d=self.iternum_d,
            iternum_g=self.iternum_g,
            freeze_bandwidth=True,
            replicate_encoder_freeze=self.replicate_reference_quirks,
            replicate_generator_detach=self.replicate_generator_detach,
            elm=self.elm,
            mmd_impl=self.mmd_impl,
            generator_grad=self.generator_grad,
            gumbel_tau=self.gumbel_tau,
            latent_override=self.latent_size,
        )

    def get_the_networks(self, ndims: int, latent_size: int, device: str = None):
        """``(generator, detector)`` modules, on ``device`` (default: the
        estimator's)."""
        dev = resolve_device(device) if device is not None else self.device
        config = self._make_config(ndims, self.batch_size)
        return config.generator_module(kl=True).to(dev), config.detector_module().to(dev)

    def fit(self, X):
        """Train generator and detector adversarially on X, in the phases of
        ``AlternationSchedule(iternum_d, iternum_g)``. The loss histories
        stay on the device and are fetched once, at the end; each epoch
        records the most recent loss of each kind (NaN before the first)."""
        t_start = time.time()
        X, config = self._prepare_fit_config(X)
        x_dev = torch.as_tensor(np.ascontiguousarray(X, dtype=np.float32), device=self.device)
        self._schedule = AlternationSchedule(self.iternum_d, self.iternum_g)
        state = init_kl_state(config, self.seed, self.device)
        state, det_hist, gen_hist = kl_train_epochs(
            state, x_dev, self._schedule.phase_array(self.epochs), config
        )
        det_hist = det_hist.cpu().numpy().astype(np.float64)
        gen_hist = gen_hist.cpu().numpy().astype(np.float64)
        for epoch in range(self.epochs):
            if self.verbose:
                print(f"\rEpoch {epoch} of {self.epochs}")
                print(f"Average loss in the epoch Generator: {gen_hist[epoch]}")
                print(f"Average loss in the epoch Detector: {det_hist[epoch]}")
            self.train_history["generator_loss"].append(float(gen_hist[epoch]))
            self.train_history["detector_loss"].append(float(det_hist[epoch]))
        self.generator_optimizer = "Adadelta"
        self.detector_optimizer = "Adadelta"
        self.generator = state.generator
        self.detector = state.detector
        self.train_state = state
        self.bandwidth = float(state.bw_value) if bool(state.bw_is_set) else None
        self._log_metrics_jsonl(time.time() - t_start)
        self._persist_artifacts(save_detector=True)
        return self


class VGAN_no_kl(_VGANCommon):
    """Subspace generation without kernel learning: the generator alone,
    MMD in raw data space between the batch and its masked projection, with
    coverage-penalty weight 10."""

    def __init__(
        self,
        batch_size: int = 500,
        epochs: int = 2000,
        lr: float = 0.007,
        momentum: float = 0.99,
        seed: int = 777,
        weight_decay: float = 0.04,
        path_to_directory=None,
        *,
        mmd_impl: str = "auto",
        replicate_reference_quirks: bool = True,
        generator_grad: str = "reference",
        gumbel_tau: float = 1.0,
        verbose: bool = True,
        mesh=None,
        shard_features: bool = False,
        gram_matmul_dtype=None,
        model_matmul_dtype=None,
        opt_state_dtype=None,
        fit_impl: str = "scan",
        checkpoint_dir=None,
        checkpoint_every: int = None,
        device=None,
    ):
        super().__init__(path_to_directory)
        _reject_left_out(mesh, shard_features, checkpoint_dir, checkpoint_every,
                         gram_matmul_dtype=gram_matmul_dtype,
                         model_matmul_dtype=model_matmul_dtype,
                         opt_state_dtype=opt_state_dtype)
        if fit_impl != "scan":
            raise _not_ported(f"fit_impl={fit_impl!r} (the fused whole-fit kernel, K8)")
        self.device = resolve_device(device)
        self.storage = dict(
            batch_size=batch_size, epochs=epochs, lr=lr, momentum=momentum,
            seed=seed, weight_decay=weight_decay,
            path_to_directory=path_to_directory,
        )
        self._kl = False
        self.mesh = None
        self.shard_features = False
        self.gram_matmul_dtype = None
        self.model_matmul_dtype = None
        self.opt_state_dtype = None
        self.fit_impl = fit_impl
        self.checkpoint_dir = None
        self.checkpoint_every = None
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.momentum = momentum  # stored, never applied (reference parity)
        self.seed = seed
        self.weight_decay = weight_decay
        self.mmd_impl = mmd_impl
        self.replicate_reference_quirks = replicate_reference_quirks
        self.generator_grad = generator_grad
        self.gumbel_tau = gumbel_tau
        self.verbose = verbose
        self.bandwidth = None

    @property
    def _lr_g(self):
        return self.lr

    def _make_config(self, ndims: int, batch_size: int) -> TrainConfig:
        return TrainConfig(
            ndims=ndims,
            batch_size=batch_size,
            lr_g=self.lr,
            weight_decay=self.weight_decay,
            freeze_bandwidth=True,
            mmd_impl=self.mmd_impl,
            generator_grad=self.generator_grad,
            gumbel_tau=self.gumbel_tau,
        )

    def get_the_networks(self, ndims: int, latent_size: int, device: str = None) -> GeneratorBig:
        """The generator module, on ``device`` (default: the estimator's)."""
        dev = resolve_device(device) if device is not None else self.device
        return self._make_config(ndims, self.batch_size).generator_module(kl=False).to(dev)

    def fit(self, X):
        """Train the generator on X. The loss history stays on the device
        and is fetched once, at the end."""
        t_start = time.time()
        X, config = self._prepare_fit_config(X)
        x_dev = torch.as_tensor(np.ascontiguousarray(X, dtype=np.float32), device=self.device)
        state = init_no_kl_state(config, self.seed, self.device)
        state, losses = no_kl_train_epochs(state, x_dev, config, self.epochs)
        losses = losses.cpu().numpy().astype(np.float64)
        for epoch, loss in enumerate(losses):
            if self.verbose:
                print(f"\rEpoch {epoch} of {self.epochs}")
                print(f"Average loss in the epoch: {loss}")
            self.train_history["generator_loss"].append(float(loss))
        self.generator_optimizer = "Adadelta"
        self.generator = state.generator
        self.train_state = state
        self.bandwidth = float(state.bw_value) if bool(state.bw_is_set) else None
        self._log_metrics_jsonl(time.time() - t_start)
        self._persist_artifacts(save_detector=False)
        return self
