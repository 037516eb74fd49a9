"""Operations: activations, the MMD loss, the permutation test and the CUDA kernels."""
