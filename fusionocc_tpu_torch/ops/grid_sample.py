"""Bilinear and trilinear resizes with ``align_corners=True``.

Port of ``resize_bilinear`` / ``resize_trilinear`` of
``fusionocc_tpu/ops/grid_sample.py`` (the FPN upsamples); both are
``torch.nn.functional.interpolate``, which computes in float32.
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
