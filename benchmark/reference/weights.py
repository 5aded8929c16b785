"""The seeded weights both sides are given.

The rule of the port's ``spread_weights``, made on the device in a few
large draws: conv and linear weights (spconv weights included) normal with
standard deviation sqrt(2 / fan_in), fan_in the size of one output row's
slice ``w[0]``; zero biases; unit norm scales, zero shifts; BatchNorm
running mean 0 and variance 1 (or the statistics the caller gives); the
relative position bias tables truncated
normal(0.02) at 2 sigma; the predicter's last weight centred over its
inputs, so that predictions are spread over many classes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .layers import BatchNorm, LayerNorm
from .lidar_encoder import SpConv


@torch.no_grad()
def make_weights(model: nn.Module, generator: torch.Generator, device,
                 statistics: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The state dict (parameters and BatchNorm statistics) of ``model``'s
    structure (which may live on the meta device), on ``device``;
    ``statistics``: running statistics by name in place of 0 and 1."""
    out: Dict[str, torch.Tensor] = {}
    normal = []                         # (name, shape, scale)
    for prefix, mod in model.named_modules():
        pre = prefix + '.' if prefix else ''
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, SpConv)):
            w = mod.weight
            normal.append((pre + 'weight', w.shape,
                           (2.0 / w[0].numel()) ** 0.5))
            if getattr(mod, 'bias', None) is not None:
                out[pre + 'bias'] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            out[pre + 'weight'] = torch.ones(mod.weight.shape, device=device)
            out[pre + 'bias'] = torch.zeros(mod.bias.shape, device=device)
            if isinstance(mod, BatchNorm):
                out[pre + 'running_mean'] = torch.zeros(
                    mod.running_mean.shape, device=device)
                out[pre + 'running_var'] = torch.ones(
                    mod.running_var.shape, device=device)
    for name, p in model.named_parameters():
        if name.endswith('relative_position_bias_table'):
            normal.append((name, p.shape, None))
    total = sum(s.numel() for _, s, _ in normal)
    draws = torch.randn(total, generator=generator, device=device)
    at = 0
    for name, shape, scale in normal:
        n = shape.numel()
        x = draws[at:at + n].view(shape)
        at += n
        out[name] = x * scale if scale is not None else x.clamp(-2, 2) * 0.02
    w = out['predicter.2.weight']
    out['predicter.2.weight'] = w - w.mean(dim=1, keepdim=True)
    for name, value in (statistics or {}).items():
        if name not in out or out[name].shape != value.shape:
            raise ValueError(f'no statistic {name} of shape {value.shape}')
        out[name] = value.to(device)
    missing = {n for n, _ in model.named_parameters()} - set(out)
    if missing:
        raise ValueError(f'no rule for the parameters {sorted(missing)}')
    return out
