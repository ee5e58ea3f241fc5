"""Inference: fusion, tracker and the per-frame / clip / image steps."""
