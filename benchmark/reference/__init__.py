"""The benchmark's plain reference of PolyphonicFormer in PyTorch.

A frozen copy of the serving and training mathematics, in ordinary tensor
ops: the model (a backbone and neck found by file in ``backbones/``, kernel
and update heads, track head), the fusion, detections, tracker and map
render, the matching, losses and AdamW step, and the arithmetic of every
hand-written kernel (:mod:`.kernels`).  It imports nothing of the program under test and builds
its configuration from the benchmark's own configuration files
(:mod:`.config`).  The benchmark hands it the same state dict and inputs as
the program and compares their outputs (``benchmark/check/``).
"""
