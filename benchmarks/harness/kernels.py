"""Kernel names that the metric readers sum, from the sources they are
launched from (``vgan_tpu_torch/ops/cuda/csrc/*.cu``)."""

MMD_GRAM = (
    "transpose_pad_kernel", "dot_slices_kernel", "slices_epilogue_kernel", "finalize_sums",
    "tile_kernel", "flash_prep_kernel", "flash_s_kernel", "flash_product_kernel",
    "flash_tile_kernel", "flash_finalize", "round_rows_kernel", "cluster_gram_kernel",
    "flash_cluster_kernel",
)
KNN_STREAM = ("knn_prep_kernel", "knn_kernel")
