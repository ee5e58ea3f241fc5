"""What the port's evaluation CLIs share: the device, the configuration and
the model from a JAX CLI checkpoint."""
from __future__ import annotations


def select_device(name: str):
    """``torch.device(name)``; a CUDA device raises when there is no card
    (a CLI runs on the CPU only when asked to).  On the card the f32 path
    keeps full f32 math: no TF32 in cuBLAS or cuDNN."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name}: no CUDA card found; pass --device cpu "
                               "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def experiment(preset, overrides=None, with_track: bool = False):
    """The preset's configuration, or the default (full R50) one with the
    track head when ``with_track``; then the ``--set`` overrides."""
    import dataclasses

    from ..configs import ExperimentConfig, apply_overrides, get_preset, parse_overrides

    if preset:
        exp = get_preset(preset)
    else:
        exp = ExperimentConfig()
        if with_track:
            exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                                     with_track=True))
    if overrides:
        exp = apply_overrides(exp, parse_overrides(overrides))
    return exp


def load_model(checkpoint: str, cfg, device):
    """The model on ``device`` with the weights of ``checkpoint``, the JAX
    CLIs' ``.pkl`` of numpy variables."""
    from ..models import build_model
    from ..weights import from_jax_variables, load_variables

    return build_model(cfg, device,
                       state_dict=from_jax_variables(load_variables(checkpoint), cfg))
