"""PyTorch + CUDA port of PolyphonicFormer for NVIDIA Hopper.

Imports torch, never jax.  See README.md, section "PyTorch port".
"""
