"""Multi-scale deformable attention's sampling (Deformable DETR,
arXiv:2010.04159; mmcv's ``multi_scale_deformable_attn_pytorch``).

Every query, head, level and point samples the level's value map
bilinearly at its location (normalised to [0, 1] over the map, pixel
centres at (i + 0.5) / size, zeros outside: ``grid_sample`` with
``align_corners=False``) and the samples are summed with the attention
weights.  BEVFormer's temporal and spatial attention both end in it.

``ms_deform_attn`` is a plain composition on every device: per level one
``grid_sample`` over the heads, then the weighted sum over the points,
accumulated level by level in float32 so no (levels x points) stack is
held.  A hand-written kernel is queued (ROADMAP D).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   locations: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """value (B, S, H, d), the levels' (h, w) maps flattened row-major and
    concatenated (S = sum h*w); locations (B, Q, H, L, P, 2) as (x, y) in
    [0, 1]; weights (B, Q, H, L, P).  Returns (B, Q, H*d) float32, the
    sums' own precision: the callers average or add the outputs before
    they round them to the compute dtype."""
    B, S, H, d = value.shape
    _, Q, _, L, P, _ = locations.shape
    if sum(h * w for h, w in shapes) != S or len(shapes) != L:
        raise ValueError(f'{len(shapes)} levels of {list(shapes)} do not '
                         f'make the {S} values of {L} levels')
    grids = (2.0 * locations.float() - 1.0).transpose(1, 2)  # (B,H,Q,L,P,2)
    w = weights.float().transpose(1, 2)                       # (B,H,Q,L,P)
    out = None
    start = 0
    for lvl, (h, wd) in enumerate(shapes):
        v = value[:, start:start + h * wd].float()
        start += h * wd
        v = v.permute(0, 2, 3, 1).reshape(B * H, d, h, wd)
        g = grids[:, :, :, lvl].reshape(B * H, Q, P, 2)
        s = F.grid_sample(v, g, mode='bilinear', padding_mode='zeros',
                          align_corners=False)               # (BH, d, Q, P)
        part = (s * w[:, :, :, lvl].reshape(B * H, 1, Q, P)).sum(-1)
        out = part if out is None else out + part
    return (out.view(B, H, d, Q).permute(0, 3, 1, 2)
            .reshape(B, Q, H * d).contiguous())
