"""Frustum-to-voxel pooling, plain PyTorch (the reference of K1).

    out[b, z, y, x, c] = sum over frustum points p falling in that voxel of
                         depth[p] * feat[pixel(p), c]

summed in fp32 by ``index_add_`` over the points in their natural order
(no sort, no runs), cast once to ``out_dtype``; autograd differentiates
it.  ``PoolingIndex`` holds each point's voxel rank (``num_voxels`` where
it leaves the grid) and its feature row.  ``bev_pool_flops`` is the frozen
formula: one multiply-add per point in the grid and channel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import GridConfig
from .counting import kernel_call


class PoolingIndex(NamedTuple):
    rank: torch.Tensor          # (P,) int64 voxel rank, num_voxels outside
    feat_row: torch.Tensor      # (P,) int64 row of the (B*N*h*w, C) feature
    num_voxels: int


def prepare_pooling_index(coor: torch.Tensor, grid: GridConfig
                          ) -> PoolingIndex:
    """The index of (B, N, D, h, w, 3) ego coordinates; rank =
    ((b * Z + z) * Y + y) * X + x."""
    B, N, D, H, W, _ = coor.shape
    gx, gy, gz = grid.grid_size
    num_voxels = B * gz * gy * gx
    dev = coor.device
    lower = torch.tensor(grid.lower_bound, dtype=torch.float32, device=dev)
    interval = torch.tensor(grid.interval, dtype=torch.float32, device=dev)
    v = torch.floor((coor.float() - lower) / interval).long()
    inside = ((v[..., 0] >= 0) & (v[..., 0] < gx) &
              (v[..., 1] >= 0) & (v[..., 1] < gy) &
              (v[..., 2] >= 0) & (v[..., 2] < gz))
    b = torch.arange(B, device=dev).view(B, 1, 1, 1, 1)
    rank = ((b * gz + v[..., 2]) * gy + v[..., 1]) * gx + v[..., 0]
    rank = torch.where(inside, rank, num_voxels).reshape(-1)
    rows = torch.arange(B * N * H * W, device=dev).view(B, N, 1, H, W)
    feat_row = rows.expand(B, N, D, H, W).reshape(-1)
    return PoolingIndex(rank, feat_row, num_voxels)


def bev_pool_plain(depth_flat, feat_flat, idx: PoolingIndex) -> torch.Tensor:
    prod = depth_flat.float()[:, None] * feat_flat.float()[idx.feat_row]
    out = torch.zeros(idx.num_voxels + 1, feat_flat.shape[1],
                      dtype=torch.float32, device=feat_flat.device)
    return out.index_add(0, idx.rank, prod)[:idx.num_voxels]


def bev_pool_flops(idx: PoolingIndex, channels: int) -> int:
    return 2 * int((idx.rank < idx.num_voxels).sum()) * channels


def bev_pool(depth: torch.Tensor, feat: torch.Tensor, idx: PoolingIndex,
             grid: GridConfig, out_dtype: torch.dtype = torch.float32
             ) -> torch.Tensor:
    """depth (B, N, D, h, w) float32, feat (B, N, h, w, C) -> (B, Z, Y, X,
    C) in ``out_dtype``."""
    C = feat.shape[-1]
    gx, gy, gz = grid.grid_size
    B = idx.num_voxels // (gz * gy * gx)
    out = kernel_call(lambda d, f: bev_pool_plain(d, f, idx),
                      lambda: bev_pool_flops(idx, C),
                      depth.reshape(-1), feat.reshape(-1, C))
    return out.to(out_dtype).reshape(B, gz, gy, gx, C)
