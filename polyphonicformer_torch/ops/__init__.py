"""Tensor ops of the port; kernels with their plain versions in ``cuda/``."""
