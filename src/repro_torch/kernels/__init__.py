"""Hand-written Hopper kernels (``csrc/``), their builder and wrappers."""
