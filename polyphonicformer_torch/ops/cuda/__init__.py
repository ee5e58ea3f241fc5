"""Hand-written CUDA kernels (``csrc/``), each with its plain PyTorch version
and a launch counter (``KERNEL.launches``)."""
