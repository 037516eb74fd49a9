"""Subspace-ensemble outlier detection over V-GAN-sampled subspaces."""

from vgan_tpu_torch.ensemble.od import (
    SubspaceEnsemble,
    knn_scores_masked,
    mean_dist_scores_masked,
    random_subspaces,
)

__all__ = [
    "SubspaceEnsemble",
    "knn_scores_masked",
    "mean_dist_scores_masked",
    "random_subspaces",
]
