"""Resizes and bilinear grid sampling, computed in float32.

Port of ``fusionocc_tpu/ops/grid_sample.py``: ``resize_bilinear`` /
``resize_trilinear`` (the FPN upsamples, ``align_corners=True``) are
``torch.nn.functional.interpolate``; ``grid_sample_2d`` (the temporal BEV
warp of streaming inference) is ``torch.nn.functional.grid_sample``, which
the JAX package builds from gathers.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (B, C, *out_hw)."""
    return F.interpolate(x, size=tuple(out_hw), mode='bilinear',
                         align_corners=True)


def resize_trilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Trilinear x``scale`` upsample of (B, C, D, H, W)."""
    D, H, W = x.shape[2:]
    return F.interpolate(x, size=(D * scale, H * scale, W * scale),
                         mode='trilinear', align_corners=True)


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Sample (B, C, H, W) at the normalised grid (B, Ho, Wo, 2) of (x, y),
    bilinearly; coordinates in [-1, 1], samples outside read zeros.
    Returns (B, C, Ho, Wo) float32."""
    return F.grid_sample(img.float(), grid.float(), mode='bilinear',
                         padding_mode='zeros', align_corners=align_corners)
