"""Gated adaptive kernel update (K-Net); mirrors
``polyphonicformer_tpu/models/kernel_updator.py``."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class KernelUpdator(nn.Module):
    def __init__(self, channels: int = 256):
        super().__init__()
        c = channels
        self.channels = c
        self.dynamic_layer = nn.Linear(c, 2 * c)
        self.input_layer = nn.Linear(c, 2 * c)
        self.input_gate = nn.Linear(c, c)
        self.update_gate = nn.Linear(c, c)
        self.fc_layer = nn.Linear(c, c)
        for name in ("norm_in", "norm_out", "input_norm_in", "input_norm_out", "fc_norm"):
            self.add_module(name, nn.LayerNorm(c, eps=1e-5))

    def forward(self, update_feature: torch.Tensor,
                input_feature: torch.Tensor) -> torch.Tensor:
        """update_feature: (B, N, C) pooled features; input_feature: (B, N, C)
        current kernels.  Returns (B, N, C)."""
        c = self.channels
        params = self.dynamic_layer(update_feature)
        param_in, param_out = params[..., :c], params[..., c:]
        inputs = self.input_layer(input_feature)
        input_in, input_out = inputs[..., :c], inputs[..., c:]
        gate_feats = input_in * param_in
        input_gate = torch.sigmoid(self.input_norm_in(self.input_gate(gate_feats)))
        update_gate = torch.sigmoid(self.norm_in(self.update_gate(gate_feats)))
        param_out = self.norm_out(param_out)
        input_out = self.input_norm_out(input_out)
        features = update_gate * param_out + input_gate * input_out
        return F.relu(self.fc_norm(self.fc_layer(features)))
