"""The model as ``nn.Module``s (NCHW inside, reference state-dict keys)."""
from .polyphonic import ModelOutput, PolyphonicFormer, build_model, init_weights

__all__ = ["ModelOutput", "PolyphonicFormer", "build_model", "init_weights"]
