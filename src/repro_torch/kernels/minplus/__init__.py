"""The min-plus and masked-matmul contraction kernels of a visit."""
