"""Masked dense 3D convs for the late sparse-encoder stages (the dense tail).

Port of ``fusionocc_tpu/ops/dense_conv.py``.  From stage ``dense_from`` on,
the encoder densifies its voxel set (exact zeros at inactive cells) and runs
plain dense convs, re-masking every output to the active set:

- SubM: the active set is kept; inactive inputs are zeros, so the conv sees
  the operands a sparse conv would.
- Stride 2 (k3, p1): an output site is active iff any active input lies in
  its receptive field, a 3x3x3 stride-2 max pool of the mask.

The conv is one cuDNN ``F.conv3d`` with fp32 accumulation over (B, X, Y, Z,
C) cells.  The JAX package's two formulations (``dense_mode`` 'zbatch', three
z-shifted 2D convs over (B, Z, X, Y, C), and 'xla3d', one NDHWC conv) compute
this same conv, so the port has one layout for both.  Weights are
(27, Cin, Cout) in ``KERNEL_OFFSETS`` (dx, dy, dz) order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .sparse_conv import sparse_to_dense
from .zfold import ZFoldVoxels, expand_lane_mask, super_shape


def dense_conv3d(x: torch.Tensor, w27: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """out[o] = sum_k x[o*stride + k - 1] @ W[k], zero padded, over the
    three spatial axes of x (B, X, Y, Z, Cin)."""
    cin, cout = w27.shape[1], w27.shape[2]
    w = w27.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype), stride=stride,
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


def strided_out_mask(mask: torch.Tensor) -> torch.Tensor:
    """Active set of a stride-2 k3 p1 sparse conv over (B, X, Y, Z)."""
    pooled = F.max_pool3d(mask[:, None].float(), 3, stride=2, padding=1)
    return pooled[:, 0] > 0.5


def dense_from_zfold(zv: ZFoldVoxels, shape: Tuple[int, int, int], C: int):
    """Densify a z-folded set of (X, Y, Z) cells to (x, mask), (B, X, Y, Z,
    C) and (B, X, Y, Z); inactive cells are exact zeros."""
    f = zv.feats * expand_lane_mask(zv.lane_mask, C, zv.feats.dtype)
    both = torch.cat([f.reshape(*f.shape[:2], zv.fold, C),
                      zv.lane_mask[..., None].to(f.dtype)], dim=-1)
    d = sparse_to_dense(both.reshape(f.shape[0], f.shape[1], -1), zv.keys,
                        zv.mask, super_shape(shape, zv.fold))
    d = d.reshape(f.shape[0], *shape, C + 1)
    return d[..., :C].contiguous(), d[..., C] > 0.5
