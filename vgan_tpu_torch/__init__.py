"""vgan_tpu_torch: the PyTorch / CUDA port of ``vgan_tpu`` for NVIDIA Hopper.

Adversarial subspace generation for outlier detection (V-GAN), with the
same estimator API as ``vgan_tpu`` (``VGAN`` and ``VGAN_no_kl``), its
subspace ensemble (``SubspaceEnsemble``: every non-parametric base, the
dimension-decomposable bases and all fifteen parametric ones) and its
heterogeneous ensemble (``HeterogeneousEnsemble``: several base families
over one pool, standardized and combined, members optionally replaced by
``ScoreDistiller`` regressors).
The multi-bandwidth RBF MMD of every training step, the GoF test's Gram past
the dense caps and the ensemble's masked KNN scores run through hand-written
CUDA kernels (``vgan_tpu_torch.ops.cuda``), built with ``nvcc`` at first
use. Entry points run on ``cuda`` unless given ``device="cpu"``.

Serving (``vgan_tpu_torch.serving``) exports the mask sampler and the
ensemble scorers as ``torch.export`` programs that a serving process loads
with torch alone; ``python -m vgan_tpu_torch`` (``vgan_tpu_torch.cli``) runs
``fit``, ``sample``, ``export``, ``check-myopic`` and ``score`` from the
command line; ``vgan_tpu``'s Flax ``.msgpack`` generators load wherever a
generator file does. ``vgan_tpu_torch.parallel`` runs the fit, the ensemble
and the GoF test over a ``torch.distributed`` device mesh, one process per
device (``mesh=``).

This package imports neither JAX nor ``vgan_tpu``; ``vgan_tpu`` stays the
reference it is tested against.
"""

__version__ = "0.1.0"

__all__ = ["VGAN", "VGAN_no_kl", "SubspaceEnsemble", "HeterogeneousEnsemble", "TrainConfig",
           "resolve_device", "__version__"]

from vgan_tpu_torch._device import resolve_device


def __getattr__(name):
    # Lazy: importing the ops alone does not pull in the estimator stack.
    if name in ("VGAN", "VGAN_no_kl"):
        from vgan_tpu_torch.api import vgan as _vgan

        return getattr(_vgan, name)
    if name in ("SubspaceEnsemble", "HeterogeneousEnsemble"):
        import vgan_tpu_torch.ensemble as _ens

        return getattr(_ens, name)
    if name == "TrainConfig":
        from vgan_tpu_torch.train.steps import TrainConfig

        return TrainConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
