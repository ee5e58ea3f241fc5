"""Measurement scripts of the port; each runs as ``python -m polyphonicformer_torch.tools.<name>``."""
