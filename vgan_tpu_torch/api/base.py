"""Shared estimator plumbing: history artifacts, snapshots, persistence.

Counterpart of ``vgan_tpu.api.base``, in the reference's artifact layout:
``<dir>/train_history/generator_loss_<run>.csv``, ``<dir>/params.csv``
(upsert keyed by run number), ``<dir>/train_history.pdf``, and
``<dir>/models/generator_<run>.pt``: the generator's ``state_dict`` as the
reference saves it (keys ``main.{i}.{weight, bias}``), so the reference's
own loader reads it too; the kl estimator adds ``detector_<run>.pt`` (keys
``{encoder, decoder}.main.{i}.{weight, bias}``). A generator loads from
such a ``.pt`` or from ``vgan_tpu``'s Flax ``.msgpack``
(:mod:`vgan_tpu_torch.utils.flax_msgpack`). Two reference bugs stay
fixed, as in the JAX package: ``detector_<run>.pt`` holds the detector, not
the generator, and the models directory is created when missing.

Under a mesh (``self.mesh``) only global rank 0 writes these files and
prints the epochs; every rank then meets at a barrier
(:func:`vgan_tpu_torch.parallel.mesh.write_on_rank0`), so ranks sharing one
directory leave one run's files.
"""

from __future__ import annotations

import os
import re
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch


class EstimatorBase:
    """Common history / snapshot / persistence behaviour."""

    def __init__(self, path_to_directory=None):
        self.train_history = defaultdict(list)
        self.path_to_directory = path_to_directory
        self.generator_optimizer = None
        self.seed: Optional[int] = None

    def get_params(self) -> dict:
        """Hyperparameter dict, same keys as the reference."""
        return {
            "batch size": self.batch_size,
            "epochs": self.epochs,
            "lr_g": self._lr_g,
            "momentum": self.momentum,
            "weight decay": self.weight_decay,
            "batch_size": self.batch_size,
            "seed": self.seed,
            "generator optimizer": self.generator_optimizer,
        }

    @property
    def _prints(self) -> bool:
        """Print the epochs? ``verbose``, and under a mesh on rank 0 only."""
        from vgan_tpu_torch.parallel.mesh import is_rank0

        return self.verbose and is_rank0(getattr(self, "mesh", None))

    def _on_rank0(self, write, *args, **kwargs):
        """``write(*args, **kwargs)``; under a mesh on rank 0 only, then a
        barrier of every rank."""
        from vgan_tpu_torch.parallel.mesh import write_on_rank0

        return write_on_rank0(getattr(self, "mesh", None), write, *args, **kwargs)

    def model_snapshot(self, path_to_directory=None, run_number=0, show=False):
        """Write the per-epoch loss CSV, upsert ``params.csv`` by run
        number, and render the loss-curve PDF (rank 0 only under a mesh)."""
        self._on_rank0(self._write_snapshot, path_to_directory, run_number, show)

    def _write_snapshot(self, path_to_directory=None, run_number=0, show=False):
        import pandas as pd

        if path_to_directory is None:
            path_to_directory = self.path_to_directory
        path_to_directory = Path(path_to_directory)
        path_to_directory.mkdir(parents=True, exist_ok=True)
        (path_to_directory / "train_history").mkdir(exist_ok=True)

        pd.DataFrame(self.train_history["generator_loss"]).to_csv(
            path_to_directory / "train_history" / f"generator_loss_{run_number}.csv",
            header=False,
            index=False,
        )
        params_path = path_to_directory / "params.csv"
        if not params_path.is_file():
            pd.DataFrame(self.get_params(), [run_number]).to_csv(params_path)
        else:
            params = pd.read_csv(params_path, index_col=0)
            params_new = pd.DataFrame(self.get_params(), [run_number])
            params = params.reindex(params.index.union(params_new.index))
            params.update(params_new)
            params.to_csv(params_path)
        self._plot_loss(path_to_directory, show=show)

    def _plot_loss(self, path_to_directory, show=False):
        """Loss-curve PDF in the reference's styling; skipped, with a
        warning, where matplotlib is not installed (the package itself needs
        only torch, numpy and pandas)."""
        try:
            import matplotlib
        except ImportError:
            warnings.warn("matplotlib is not installed: train_history.pdf is not written",
                          RuntimeWarning, stacklevel=3)
            return

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.style.use("ggplot")
        generator_y = self.train_history["generator_loss"]
        x = np.linspace(1, len(generator_y), len(generator_y))
        fig, ax = plt.subplots()
        ax.plot(x, generator_y, color="cornflowerblue", label="Generator loss", linewidth=2)
        if self.train_history.get("detector_loss"):
            ax.plot(x, self.train_history["detector_loss"], color="black",
                    label="Detector loss", linewidth=2)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        ax.legend(loc="upper right")
        plt.savefig(Path(path_to_directory) / "train_history.pdf", format="pdf", dpi=1200)
        plt.close(fig)
        if show:
            # reference message, quoted verbatim
            print("The show option has been depricated due to lack of utility")

    def _log_metrics_jsonl(self, wall_seconds: float) -> None:
        """JSONL metrics beside the CSV artifacts, when a directory is set
        (rank 0 only under a mesh)."""
        if self.path_to_directory is not None:
            self._on_rank0(self._write_metrics_jsonl, wall_seconds)

    def _write_metrics_jsonl(self, wall_seconds: float) -> None:
        from vgan_tpu_torch.utils.metrics import MetricsLogger

        path = Path(self.path_to_directory) / "metrics.jsonl"
        with MetricsLogger(path) as ml:
            ml.log(
                "fit",
                estimator=type(self).__name__,
                wall_seconds=wall_seconds,
                epochs=len(self.train_history["generator_loss"]),
                params={k: str(v) for k, v in self.get_params().items()},
            )
            keys = [k for k, v in self.train_history.items() if v]
            for i in range(len(self.train_history["generator_loss"])):
                ml.log("epoch", epoch=i, **{k: self.train_history[k][i] for k in keys})

    @staticmethod
    def _save_module(models_dir: Path, name: str, run_number: int, module) -> Path:
        models_dir.mkdir(parents=True, exist_ok=True)
        path = models_dir / f"{name}_{run_number}.pt"
        state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        torch.save(state, path)
        return path

    def _save_generator(self, models_dir: Path, run_number: int, module) -> Path:
        return self._save_module(models_dir, "generator", run_number, module)

    def _save_detector(self, models_dir: Path, run_number: int, module) -> Path:
        return self._save_module(models_dir, "detector", run_number, module)

    @staticmethod
    def _count_runs(models_dir: Path) -> int:
        """Next free run number: one past the highest generator index. (The
        reference divides the file count by the files saved per run, which
        overwrites runs when other files share the directory; the index scan
        replaces it, as in the JAX package.)"""
        if not models_dir.exists():
            return 0
        best = -1
        for name in os.listdir(models_dir):
            m = re.match(r"generator_(\d+)\.(msgpack|pt)$", name)
            if m:
                best = max(best, int(m.group(1)))
        return best + 1

    @staticmethod
    def _load_state_dict(path) -> dict:
        """A generator ``state_dict`` from a reference-layout ``.pt`` file or
        from ``vgan_tpu``'s Flax ``.msgpack`` (``{"params": {"Dense_i":
        {"kernel", "bias"}}}``, carried over by
        :func:`~vgan_tpu_torch.interop.generator_state_dict_from_jax`)."""
        path = Path(path)
        if path.suffix == ".msgpack":
            state = _state_dict_from_msgpack(path)
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
        layers = sorted({int(k.split(".")[1]) for k in state if k.startswith("main.")})
        if len(layers) != 4:
            raise ValueError(
                "state_dict does not look like a reference generator (expected "
                "4 'main.<i>.weight/bias' Linear layers; found layer indices "
                f"{layers}) - wrong checkpoint file?"
            )
        return {
            f"main.{i}.{part}": state[f"main.{j}.{part}"]
            for i, j in enumerate(layers)
            for part in ("weight", "bias")
        }


def _state_dict_from_msgpack(path: Path) -> dict:
    """``main.{i}.{weight, bias}`` float32 tensors from a Flax generator
    file; a tree of other layers (a detector's) gives no ``main.`` key."""
    from vgan_tpu_torch.interop import generator_state_dict_from_jax
    from vgan_tpu_torch.utils.flax_msgpack import load_msgpack

    tree = load_msgpack(path)
    tree = tree.get("params", tree) if isinstance(tree, dict) else {}
    dense = {
        name: {part: (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
                      else np.asarray(leaf, np.float32))
               for part, leaf in layer.items()}
        for name, layer in tree.items()
        if re.fullmatch(r"Dense_\d+", str(name)) and isinstance(layer, dict)
        and {"kernel", "bias"} <= set(layer)
    }
    return generator_state_dict_from_jax(dense) if len(dense) == len(tree) else {}
