"""Modulated deformable convolution, DCNv2 (Zhu et al., arXiv:1811.11168;
mmcv's ``modulated_deform_conv2d``, one deformable group).

Tap k = (i, j) of output pixel (y, x) reads the input bilinearly at
(y * stride - pad + i * dilation + dy_k, x * stride - pad + j * dilation +
dx_k), zeros outside the map, times its mask m_k; the taps' columns meet
the weight in one product.  ``offset`` holds (dy_k, dx_k) at channels
(2k, 2k + 1), mmcv's layout.

``modulated_deform_conv2d`` is a plain composition on every device: one
``grid_sample`` of the input in float32 at every tap's location, the mask,
the columns cast to the input's dtype, one batched matmul.  A hand-written
kernel is queued (ROADMAP D).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            stride: int = 1, padding: int = 1,
                            dilation: int = 1) -> torch.Tensor:
    """x (B, C, H, W); offset (B, 2*kh*kw, Ho, Wo); mask (B, kh*kw, Ho,
    Wo); weight (Cout, C, kh, kw) in x's dtype.  Returns (B, Cout, Ho, Wo)
    in x's dtype."""
    B, C, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    Ho, Wo = offset.shape[2:]
    dev = x.device
    ky = (torch.arange(kh, device=dev) * dilation).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dilation).repeat(kh)
    oy = torch.arange(Ho, device=dev) * stride - padding
    ox = torch.arange(Wo, device=dev) * stride - padding
    off = offset.float().view(B, K, 2, Ho, Wo)
    ys = ky.view(1, K, 1, 1) + oy.view(1, 1, Ho, 1) + off[:, :, 0]
    xs = kx.view(1, K, 1, 1) + ox.view(1, 1, 1, Wo) + off[:, :, 1]
    # pixel p sits at the normalised (2p + 1) / size - 1 of align_corners
    # False, for every size
    grid = torch.stack([(2 * xs + 1) / W - 1, (2 * ys + 1) / H - 1], -1)
    cols = F.grid_sample(x.float(), grid.view(B, K * Ho, Wo, 2),
                         mode='bilinear', padding_mode='zeros',
                         align_corners=False)            # (B, C, K*Ho, Wo)
    cols = cols.view(B, C, K, Ho, Wo) * mask.float().view(B, 1, K, Ho, Wo)
    y = torch.matmul(weight.reshape(Cout, C * K),
                     cols.reshape(B, C * K, Ho * Wo).to(x.dtype))
    y = y.view(B, Cout, Ho, Wo)
    return y if bias is None else y + bias.view(1, -1, 1, 1)
