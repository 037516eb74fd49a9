"""The ``VGAN`` and ``VGAN_no_kl`` estimators (counterpart of ``vgan_tpu.api.vgan``).

Same constructor names and defaults, same workflow: ``fit`` ->
``generate_subspaces`` -> ``approx_subspace_dist`` -> ``check_if_myopic``,
plus ``model_snapshot``, ``load_models``, ``get_params``,
``get_the_networks``, ``train_history``, full-train-state checkpoints
(``save_checkpoint``, ``restore_checkpoint``, ``continue_fit``,
``checkpoint_dir`` / ``checkpoint_every``) and, for ``VGAN_no_kl``, the
fused whole-fit path (``fit_impl='fused'``). It runs on ``cuda`` unless
given ``device="cpu"``.

With ``mesh=`` (:func:`vgan_tpu_torch.parallel.make_mesh`) every rank of the
mesh's world builds the same estimator and calls ``fit`` with the same data:
each keeps its block of the dataset (columns too with ``shard_features``),
the fit runs data-parallel (:mod:`vgan_tpu_torch.parallel.dp`) with the
state replicated, ``check_if_myopic`` shards its permutation rows past the
dense caps, and only rank 0 prints the epochs and writes artifacts and
checkpoints.

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
from vgan_tpu_torch.parallel.mesh import check_mesh_device
from vgan_tpu_torch.train.steps import (
    WHOLE,
    AlternationSchedule,
    TrainConfig,
    init_kl_state,
    init_no_kl_state,
    kl_train_epochs,
    no_kl_train_epochs,
)


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
        only), through the kernel past 8192 pooled rows. Under a mesh the
        kernel routes shard their permutation rows over 'data'.
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
                device=self.device, mesh=self.mesh,
            )
        else:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            _, pvals = mmd_permutation_test_sweep(
                torch.from_numpy(x_sample), torch.from_numpy(ux_sample),
                alphas=alphas, generator=g, n_permutations=n_permutations,
                device=self.device, mesh=self.mesh,
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
        """Load a trained generator for sampling, onto ``device`` (default:
        this estimator's device). Both formats load: a reference-layout
        ``.pt`` (what this package's ``fit`` writes) and ``vgan_tpu``'s Flax
        ``.msgpack``."""
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
        """Persist the full train state (parameters, optimizer state,
        bandwidth, RNG state, schedule counters) for exact resume on the
        same device type. The live state's frozen bandwidth is stored:
        ``self.bandwidth`` may be stale (a previous fit's, or
        ``check_if_myopic``'s)."""
        from vgan_tpu_torch.train.steps import train_state_to_payload
        from vgan_tpu_torch.utils.checkpoint import save_train_state

        state = getattr(self, "train_state", None)
        if state is None:
            raise RuntimeError("save_checkpoint needs a fitted train state: call fit first")
        bandwidth = float(state.bw_value) if bool(state.bw_is_set) else self.bandwidth
        schedule = getattr(self, "_schedule", None)
        meta = {
            "class": type(self).__name__,
            "ndims": self._ndims,
            "batch_size": self.batch_size,
            "train_history": {k: list(v) for k, v in self.train_history.items()},
            "bandwidth": bandwidth,
            "schedule": schedule.get_state() if schedule is not None else None,
        }
        save_train_state(path, train_state_to_payload(state), meta, mesh=self.mesh)

    def restore_checkpoint(self, path):
        """Restore a checkpoint written by :meth:`save_checkpoint` onto this
        estimator's device. Raises ``ValueError`` for another class's
        checkpoint."""
        from vgan_tpu_torch.train.steps import train_state_from_payload
        from vgan_tpu_torch.utils.checkpoint import load_meta, restore_train_state

        meta = load_meta(path)
        if meta is None:
            raise FileNotFoundError(f"no checkpoint metadata at {path}")
        if meta["class"] != type(self).__name__:
            raise ValueError(f"checkpoint is for {meta['class']}, not {type(self).__name__}")
        self._ndims = meta["ndims"]
        self.batch_size = meta["batch_size"]
        self._config = self._make_config(self._ndims, self.batch_size)
        self._latent_size = self._config.latent_size
        self.train_state = train_state_from_payload(restore_train_state(path), self._config,
                                                    self.device)
        self.train_history.clear()
        for k, v in meta["train_history"].items():
            self.train_history[k].extend(v)
        self.bandwidth = meta["bandwidth"]
        self.generator = self.train_state.generator
        if self._kl:
            self._schedule = AlternationSchedule(self.iternum_d, self.iternum_g)
            if meta.get("schedule"):
                self._schedule.set_state(meta["schedule"])
            self.detector = self.train_state.detector
        self.generator_optimizer = "Adadelta"
        return self

    def continue_fit(self, X, epochs: int):
        """Run ``epochs`` more training epochs from the current state (after
        ``fit`` or ``restore_checkpoint``), on the scan path."""
        X = np.asarray(X)
        if X.shape[0] < self._config.batch_size:
            raise ValueError(
                f"continue_fit dataset has {X.shape[0]} rows but the "
                f"checkpointed batch_size is {self._config.batch_size}; "
                "drop-last batching would train zero batches"
            )
        x_dev = self._place_dataset(X)
        layout = self._layout()
        if self._kl:
            state, det_hist, gen_hist = kl_train_epochs(
                self.train_state, x_dev, self._schedule.phase_array(epochs), self._config,
                layout=layout)
            det_hist = det_hist.cpu().numpy().astype(np.float64)
            gen_hist = gen_hist.cpu().numpy().astype(np.float64)
            # continue the last-seen-loss semantics across the resume point
            prev_d = self.train_history["detector_loss"]
            prev_g = self.train_history["generator_loss"]
            if prev_d:
                det_hist[np.isnan(det_hist)] = prev_d[-1]
            if prev_g:
                gen_hist[np.isnan(gen_hist)] = prev_g[-1]
            prev_d.extend(float(v) for v in det_hist)
            prev_g.extend(float(v) for v in gen_hist)
            self.detector = state.detector
        else:
            state, losses = no_kl_train_epochs(self.train_state, x_dev, self._config, epochs,
                                               layout=layout)
            self.train_history["generator_loss"].extend(
                float(v) for v in losses.cpu().numpy().astype(np.float64))
        self._finalize_fit(state)
        return self

    def _finalize_fit(self, state) -> None:
        self.generator = state.generator
        self.train_state = state
        self.bandwidth = float(state.bw_value) if bool(state.bw_is_set) else None

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

    def _place_dataset(self, X) -> torch.Tensor:
        """The dataset on the device as float32: this rank's block under a
        mesh (:func:`~vgan_tpu_torch.parallel.input.shard_dataset`), whole
        otherwise."""
        X = np.ascontiguousarray(X, dtype=np.float32)
        if self.mesh is not None:
            from vgan_tpu_torch.parallel.input import shard_dataset

            return shard_dataset(X, self.mesh, shard_features=self.shard_features)
        return torch.as_tensor(X, device=self.device)

    def _layout(self):
        """How a training step splits: over the mesh's 'data' ranks, or not."""
        if self.mesh is None:
            return WHOLE
        from vgan_tpu_torch.parallel.dp import MeshBatches

        return MeshBatches(self.mesh, self._config.batch_size, self.shard_features)

    def _persist_artifacts(self, save_detector: bool):
        """The reference-layout artifacts of a finished fit (rank 0 only
        under a mesh)."""
        if self.path_to_directory is None:
            return
        self._on_rank0(self._write_artifacts, save_detector)

    def _write_artifacts(self, save_detector: bool):
        path = Path(self.path_to_directory)
        models_dir = path / "models"
        run_number = self._count_runs(models_dir)
        self._save_generator(models_dir, run_number, self.generator)
        if save_detector:
            self._save_detector(models_dir, run_number, self.detector)
        self._write_snapshot(path, run_number, show=False)


def _check_mesh(mesh, shard_features: bool, device) -> None:
    check_mesh_device(mesh, device)
    if shard_features and mesh is None:
        raise ValueError("shard_features=True shards the feature axis over a mesh's 'model' "
                         "axis: it needs mesh=")


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
        self.device = resolve_device(device)
        _check_mesh(mesh, shard_features, self.device)
        self.storage = dict(
            batch_size=batch_size, temperature=temperature, epochs=epochs,
            lr_G=lr_G, lr_D=lr_D, iternum_d=iternum_d, iternum_g=iternum_g,
            momentum=momentum, seed=seed, weight_decay=weight_decay,
            path_to_directory=path_to_directory,
        )
        self._kl = True
        self.mesh = mesh
        self.shard_features = shard_features
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.gram_matmul_dtype = gram_matmul_dtype
        self.model_matmul_dtype = model_matmul_dtype
        self.opt_state_dtype = opt_state_dtype
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
            gram_matmul_dtype=self.gram_matmul_dtype,
            model_matmul_dtype=self.model_matmul_dtype,
            opt_state_dtype=self.opt_state_dtype,
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
        stay on the device and are fetched once per chunk (one chunk, or
        ``checkpoint_every`` epochs each, with a checkpoint after each when
        ``checkpoint_dir`` is set); each epoch records the most recent loss
        of each kind (NaN before the first)."""
        t_start = time.time()
        X, config = self._prepare_fit_config(X)
        x_dev = self._place_dataset(X)
        layout = self._layout()
        self._schedule = AlternationSchedule(self.iternum_d, self.iternum_g)
        state = init_kl_state(config, self.seed, self.device)
        done = 0
        last_d, last_g = float("nan"), float("nan")
        while done < self.epochs:
            chunk = min(self.checkpoint_every or self.epochs, self.epochs - done)
            state, det_hist, gen_hist = kl_train_epochs(
                state, x_dev, self._schedule.phase_array(chunk), config, layout=layout
            )
            det_hist = det_hist.cpu().numpy().astype(np.float64)
            gen_hist = gen_hist.cpu().numpy().astype(np.float64)
            # carry the last-seen-loss semantics across chunk boundaries
            det_hist[np.isnan(det_hist)] = last_d
            gen_hist[np.isnan(gen_hist)] = last_g
            for i in range(chunk):
                if self._prints:
                    print(f"\rEpoch {done + i} of {self.epochs}")
                    print(f"Average loss in the epoch Generator: {gen_hist[i]}")
                    print(f"Average loss in the epoch Detector: {det_hist[i]}")
                self.train_history["generator_loss"].append(float(gen_hist[i]))
                self.train_history["detector_loss"].append(float(det_hist[i]))
            last_d, last_g = det_hist[-1], gen_hist[-1]
            done += chunk
            if self.checkpoint_dir is not None:
                self.train_state = state
                self.save_checkpoint(self.checkpoint_dir)
        self.generator_optimizer = "Adadelta"
        self.detector_optimizer = "Adadelta"
        self.detector = state.detector
        self._finalize_fit(state)
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
        self.device = resolve_device(device)
        _check_mesh(mesh, shard_features, self.device)
        self.storage = dict(
            batch_size=batch_size, epochs=epochs, lr=lr, momentum=momentum,
            seed=seed, weight_decay=weight_decay,
            path_to_directory=path_to_directory,
        )
        self._kl = False
        self.mesh = mesh
        self.shard_features = shard_features
        self.gram_matmul_dtype = gram_matmul_dtype
        self.model_matmul_dtype = model_matmul_dtype
        self.opt_state_dtype = opt_state_dtype
        self.fit_impl = fit_impl
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
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
            gram_matmul_dtype=self.gram_matmul_dtype,
            model_matmul_dtype=self.model_matmul_dtype,
            opt_state_dtype=self.opt_state_dtype,
            generator_grad=self.generator_grad,
            gumbel_tau=self.gumbel_tau,
        )

    def get_the_networks(self, ndims: int, latent_size: int, device: str = None) -> GeneratorBig:
        """The generator module, on ``device`` (default: the estimator's)."""
        dev = resolve_device(device) if device is not None else self.device
        return self._make_config(ndims, self.batch_size).generator_module(kl=False).to(dev)

    def _record_losses(self, losses: np.ndarray, first_epoch: int) -> None:
        for i, loss in enumerate(losses):
            if self._prints:
                print(f"\rEpoch {first_epoch + i} of {self.epochs}")
                print(f"Average loss in the epoch: {loss}")
            self.train_history["generator_loss"].append(float(loss))

    def _fit_fused(self, X, state, config, t_start):
        """The whole fit in one launch of the fused kernel (``fit_impl=
        'fused'``, ``ops/cuda/fused_no_kl.py``); on the CPU its plain
        version. Same per-step math as the scan path, other random streams
        (in-kernel noise, rotational batching). Single device, fresh fits;
        ``ValueError`` for ``mesh``, ``checkpoint_every``, ``model_matmul_dtype``
        or ``opt_state_dtype``, ``generator_grad`` other than 'reference' and
        shapes outside ``fused_supported``. As in the JAX package, the kernel
        runs in float32 whatever ``gram_matmul_dtype`` asks (ROADMAP Queue 3)."""
        from vgan_tpu_torch.ops.cuda.fused_no_kl import fused_no_kl_fit, fused_supported

        if self.mesh is not None:
            raise ValueError("fit_impl='fused' is single-device; drop mesh= or use "
                             "fit_impl='scan'")
        if self.checkpoint_every is not None:
            raise ValueError(
                "fit_impl='fused' runs the whole fit as one kernel launch; periodic "
                "checkpointing needs the scan path (fit_impl='scan')")
        if self.model_matmul_dtype is not None or self.opt_state_dtype is not None:
            raise ValueError(
                "fit_impl='fused' runs its own in-kernel f32 math and does not honor "
                "model_matmul_dtype/opt_state_dtype; use fit_impl='scan' for the bf16 options")
        if self.generator_grad != "reference":
            raise ValueError(
                "fit_impl='fused' implements the reference gradient estimator only; use "
                "fit_impl='scan' for generator_grad='st'/'gumbel_st'")
        n, ndims = X.shape
        if not fused_supported(n, ndims, self.batch_size, config.latent_size):
            raise ValueError("fused fit unsupported for this shape; use fit_impl='scan'")
        x_dev = torch.as_tensor(np.ascontiguousarray(X, dtype=np.float32), device=self.device)
        params, (sq, acc), (bw, bw_set), losses, _, _ = fused_no_kl_fit(
            x_dev, state.generator, state.opt_state, config, self.epochs, self.seed)
        self._record_losses(losses.double().mean(dim=1).cpu().numpy(), 0)
        with torch.no_grad():
            for name, p in state.generator.named_parameters():
                p.copy_(params[name])
                state.opt_state.square_avg[name].copy_(sq[name])
                state.opt_state.acc_delta[name].copy_(acc[name])
        state.bw_value = bw.detach().to(torch.float32)
        state.bw_is_set = bw_set.detach()
        self.generator_optimizer = "Adadelta"
        self._finalize_fit(state)
        self._log_metrics_jsonl(time.time() - t_start)
        if self.checkpoint_dir is not None:
            self.save_checkpoint(self.checkpoint_dir)
        self._persist_artifacts(save_detector=False)
        return self

    def fit(self, X):
        """Train the generator on X. The loss history stays on the device
        and is fetched once per chunk (one chunk, or ``checkpoint_every``
        epochs each, with a checkpoint after each when ``checkpoint_dir`` is
        set). ``fit_impl='fused'`` runs the whole fit in one kernel launch."""
        t_start = time.time()
        X, config = self._prepare_fit_config(X)
        state = init_no_kl_state(config, self.seed, self.device)
        if self.fit_impl == "fused":
            return self._fit_fused(X, state, config, t_start)
        x_dev = self._place_dataset(X)
        layout = self._layout()
        done = 0
        while done < self.epochs:
            chunk = min(self.checkpoint_every or self.epochs, self.epochs - done)
            state, losses = no_kl_train_epochs(state, x_dev, config, chunk, layout=layout)
            self._record_losses(losses.cpu().numpy().astype(np.float64), done)
            done += chunk
            if self.checkpoint_dir is not None:
                self.train_state = state
                self.save_checkpoint(self.checkpoint_dir)
        self.generator_optimizer = "Adadelta"
        self._finalize_fit(state)
        self._log_metrics_jsonl(time.time() - t_start)
        self._persist_artifacts(save_detector=False)
        return self
