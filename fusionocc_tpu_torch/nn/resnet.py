"""BEVFormer's image encoder: mmdet's ResNet in caffe style with DCNv2,
and mmdet's FPN (reference names: ``conv1``, ``bn1``, ``layer1..4`` of
``Bottleneck``s with ``conv1..3``, ``bn1..3``, ``downsample``; the DCN's
``conv_offset``; the FPN's ``lateral_convs`` and ``fpn_convs``, each a
ConvModule's ``conv``).

Caffe style puts a stage's stride on the Bottleneck's first 1x1 conv, so
the 3x3 conv (DCNv2 in the stages ``stage_with_dcn`` marks) always has
stride 1.  BatchNorm is frozen: eval mode with the running statistics,
always (mmdet's ``norm_eval``).  Tensors are NCHW; compute in the input's
dtype as ``nn/layers.py``'s modules do.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import modulated_deform_conv2d
from .layers import BatchNorm, Conv2d


class ModulatedDeformConv2d(nn.Conv2d):
    """mmcv's ``ModulatedDeformConv2dPack``, one deformable group, no bias:
    ``conv_offset`` (a 3x3 conv with bias) gives 2*k*k offsets and k*k
    mask logits (the mask a sigmoid of them)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1):
        super().__init__(cin, cout, k, stride, padding, dilation, bias=False)
        self.conv_offset = Conv2d(cin, 3 * k * k, k, stride, padding,
                                  dilation, bias=True)

    def forward(self, x):
        o1, o2, m = self.conv_offset(x).chunk(3, dim=1)
        return modulated_deform_conv2d(
            x, torch.cat([o1, o2], 1), torch.sigmoid(m.float()),
            self.weight.to(x.dtype), None, self.stride[0], self.padding[0],
            self.dilation[0])


class Bottleneck(nn.Module):
    """mmdet's Bottleneck (expansion 4), caffe style: 1x1 (stride), 3x3 or
    DCNv2, 1x1, each with BatchNorm; ReLU; the residual the input or
    ``downsample`` of it."""

    def __init__(self, cin: int, planes: int, stride: int, dcn: bool,
                 downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, stride, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = (ModulatedDeformConv2d(planes, planes) if dcn else
                      Conv2d(planes, planes, 3, 1, 1, bias=False))
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride, bias=False),
            BatchNorm(planes * 4)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


class ResNet(nn.Module):
    """The stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max pool), then stages
    of ``stage_blocks`` Bottlenecks of ``base * 2**i`` planes at strides 1,
    2, 2, 2; returns the outputs of the stages ``out_indices``."""

    def __init__(self, base: int, stage_blocks: Sequence[int],
                 stage_with_dcn: Sequence[bool], out_indices: Sequence[int]):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.num_stages = len(stage_blocks)
        self.conv1 = Conv2d(3, base, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(base)
        cin = base
        for i, (n, dcn) in enumerate(zip(stage_blocks, stage_with_dcn)):
            planes = base * 2 ** i
            blocks = [Bottleneck(cin if b == 0 else planes * 4, planes,
                                 (1 if i == 0 else 2) if b == 0 else 1, dcn,
                                 b == 0) for b in range(n)]
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            cin = planes * 4

    @property
    def out_channels(self) -> List[int]:
        return [self.conv1.out_channels * 4 * 2 ** i
                for i in self.out_indices]

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return outs


class ConvModule(nn.Module):
    """mmcv's ConvModule without a norm: ``conv`` with its bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, k // 2, bias=True)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    """mmdet's FPN from every input level, ``add_extra_convs='on_output'``:
    1x1 laterals, the top-down sum with nearest upsampling to each level's
    size, 3x3 output convs, then ``num_outs - len(in_channels)`` stride-2
    3x3 convs on the last output (a ReLU before each but the first, mmdet's
    ``relu_before_extra_convs``: with one extra level it acts nowhere)."""

    def __init__(self, in_channels: Sequence[int], out: int, num_outs: int):
        super().__init__()
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out, out, 3) for _ in in_channels]
            + [ConvModule(out, out, 3, 2) for _ in range(num_outs - n)])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        lat = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode='nearest')
        outs = [self.fpn_convs[i](x) for i, x in enumerate(lat)]
        for i in range(len(lat), len(self.fpn_convs)):
            src = outs[-1] if i == len(lat) else F.relu(outs[-1])
            outs.append(self.fpn_convs[i](src))
        return outs
