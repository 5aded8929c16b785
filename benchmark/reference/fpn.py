"""FPN necks and the 3D ResNet (reference names).

Port of ``fusionocc_tpu/models/fpn.py``: ``FPN_LSS`` (image neck, NHWC in and
out), ``LSSFPN3D`` and ``CustomResNet3D`` (voxels (B, Z, Y, X, C) in and
out; NCDHW inside for the convolutions).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from .layers import BasicBlock3D, BatchNorm, ConvBN, Conv2d
from .grid_sample import resize_bilinear, resize_trilinear


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class FPN_LSS(nn.Module):
    """Upsample the deep feature to the shallow one's size, concatenate, two
    3x3 conv+BN+ReLU (keys ``conv.0/1/3/4``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(cin, cout, 3, 1, 1, bias=False), BatchNorm(cout), nn.ReLU(),
            Conv2d(cout, cout, 3, 1, 1, bias=False), BatchNorm(cout),
            nn.ReLU())

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x2 = feats[0].permute(0, 3, 1, 2)
        x1 = feats[1].permute(0, 3, 1, 2)
        x1 = resize_bilinear(x1, x2.shape[2:]).to(x2.dtype)
        return self.conv(torch.cat([x2, x1], dim=1)).permute(0, 2, 3, 1)


class LSSFPN3D(nn.Module):
    """Trilinear x2 / x4 upsample of the coarser scales, concatenate, 1x1x1
    conv+BN+ReLU (``conv.conv``, ``conv.bn``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBN(cin, cout, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x8, x16, x32 = (_to_ncdhw(f) for f in feats)
        x = torch.cat([x8, resize_trilinear(x16, 2).to(x8.dtype),
                       resize_trilinear(x32, 4).to(x8.dtype)], dim=1)
        return _to_ndhwc(self.conv(x))


class CustomResNet3D(nn.Module):
    """Stages of BasicBlock3D (``layers.{i}.{j}``); each stage's first block
    has a 3x3x3 downsample ConvModule on the identity, even at stride 1.
    Returns every stage's output."""

    def __init__(self, cin: int, num_channels: Sequence[int],
                 num_layer: Sequence[int], strides: Sequence[int]):
        super().__init__()
        stages = []
        for c, n, s in zip(num_channels, num_layer, strides):
            blocks = [BasicBlock3D(cin, c, s, downsample=True)]
            blocks += [BasicBlock3D(c, c) for _ in range(n - 1)]
            stages.append(nn.Sequential(*blocks))
            cin = c
        self.layers = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = _to_ncdhw(x)
        feats = []
        for stage in self.layers:
            x = stage(x)
            feats.append(_to_ndhwc(x))
        return feats
