"""Subspace-ensemble outlier detection over V-GAN-sampled subspaces."""

from vgan_tpu_torch.ensemble.iforest import iforest_scores, iforest_scores_masked
from vgan_tpu_torch.ensemble.od import (
    SubspaceEnsemble,
    abod_scores_masked,
    cblof_scores_masked,
    cof_scores_masked,
    copod_dim_scores,
    ecod_dim_scores,
    gmm_scores_masked,
    hbos_dim_scores,
    kde_scores_masked,
    knn_scores_masked,
    kpca_scores_masked,
    lof_scores_masked,
    mahalanobis_scores_masked,
    mcd_scores_masked,
    mean_dist_scores_masked,
    pca_scores_masked,
    random_subspaces,
)

__all__ = [
    "SubspaceEnsemble",
    "abod_scores_masked",
    "cblof_scores_masked",
    "cof_scores_masked",
    "copod_dim_scores",
    "ecod_dim_scores",
    "gmm_scores_masked",
    "hbos_dim_scores",
    "iforest_scores",
    "iforest_scores_masked",
    "kde_scores_masked",
    "knn_scores_masked",
    "kpca_scores_masked",
    "lof_scores_masked",
    "mahalanobis_scores_masked",
    "mcd_scores_masked",
    "mean_dist_scores_masked",
    "pca_scores_masked",
    "random_subspaces",
]
