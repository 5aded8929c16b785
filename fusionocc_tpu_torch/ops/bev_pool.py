"""Frustum-to-voxel pooling (bev_pool_v2 forward).

Port of ``fusionocc_tpu/ops/bev_pool.py`` (forward only):

    out[b, z, y, x, c] = sum over frustum points p falling in that voxel of
                         depth[p] * feat[pixel(p), c]

``prepare_pooling_index`` quantises the frustum points, gives out-of-grid
points a sentinel rank one past the last voxel, sorts stably by rank and
finds each voxel's run of sorted points (``bounds``).  ``bev_pool`` then sums
the runs: the plain version by ``index_add_`` over the sorted points, the
CUDA kernel (``csrc/bev_pool.cu``) by one thread per (voxel, channel).  The
JAX package's cumulative-sum formulation and trimmed index are TPU devices
the kernel does not need; the backward's ``order_by_feat`` is left for the
training port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GridConfig
from .kernels import KERNELS, stream_ptr


class PoolingIndex(NamedTuple):
    """int32 rank tensors sorted ascending by ``ranks_bev`` (sentinel last).

    ranks_* have length P = B*N*D*Hf*Wf; ``bounds`` (num_voxels + 1,) holds
    the first sorted position with ``ranks_bev >= v``, so voxel v's points
    are ``bounds[v]:bounds[v+1]`` and ``bounds[-1]`` counts in-grid points.
    """
    ranks_depth: torch.Tensor   # into the flattened (B, N, D, Hf, Wf) depth
    ranks_feat: torch.Tensor    # into the flattened (B, N, Hf, Wf) feat rows
    ranks_bev: torch.Tensor     # voxel rank; out of grid = num_voxels
    bounds: torch.Tensor


def prepare_pooling_index(coor: torch.Tensor, grid: GridConfig
                          ) -> PoolingIndex:
    """Quantise (B, N, D, Hf, Wf, 3) ego coordinates and sort by voxel."""
    B, N, D, H, W, _ = coor.shape
    P = B * N * D * H * W
    gx, gy, gz = grid.grid_size
    num_voxels = B * gz * gy * gx
    dev = coor.device
    lower = torch.tensor(grid.lower_bound, dtype=torch.float32, device=dev)
    interval = torch.tensor(grid.interval, dtype=torch.float32, device=dev)

    v = torch.floor((coor.float() - lower) / interval).to(torch.int32)
    v = v.reshape(B, N * D * H * W, 3)
    inside = ((v[..., 0] >= 0) & (v[..., 0] < gx) &
              (v[..., 1] >= 0) & (v[..., 1] < gy) &
              (v[..., 2] >= 0) & (v[..., 2] < gz))
    batch_idx = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    # rank = ((b * Z + z) * Y + y) * X + x  (the reference's rank layout)
    rank = ((batch_idx * gz + v[..., 2]) * gy + v[..., 1]) * gx + v[..., 0]
    rank = torch.where(inside, rank, num_voxels).reshape(P).to(torch.int32)

    ranks_feat = torch.arange(B * N * H * W, dtype=torch.int32, device=dev)
    ranks_feat = ranks_feat.reshape(B, N, 1, H, W).expand(B, N, D, H, W)
    rank_s, order = torch.sort(rank, stable=True)
    rf_s = ranks_feat.reshape(P)[order]
    bounds = torch.searchsorted(
        rank_s, torch.arange(num_voxels + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return PoolingIndex(order.to(torch.int32), rf_s, rank_s, bounds)


def bev_pool_plain(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                   idx: PoolingIndex, num_voxels: int) -> torch.Tensor:
    """(num_voxels, C) float32 sums by ``index_add_`` over sorted points."""
    C = feat_flat.shape[1]
    prod = (depth_flat.float()[idx.ranks_depth.long(), None]
            * feat_flat.float()[idx.ranks_feat.long()])
    out = torch.zeros(num_voxels + 1, C, dtype=torch.float32,
                      device=feat_flat.device)
    out.index_add_(0, idx.ranks_bev.long(), prod)
    return out[:num_voxels]


def bev_pool_cuda(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                  idx: PoolingIndex, num_voxels: int) -> torch.Tensor:
    """Launch ``bev_pool_fwd``: one thread per (voxel, channel)."""
    dev = feat_flat.device
    if dev.type != 'cuda':
        raise ValueError(f'bev_pool_cuda needs CUDA tensors, got {dev}')
    C = feat_flat.shape[1]
    depth_flat = depth_flat.float().contiguous()
    feat_flat = feat_flat.float().contiguous()
    for name in ('ranks_depth', 'ranks_feat', 'bounds'):
        t = getattr(idx, name)
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous int32 on {dev}')
    if idx.bounds.shape != (num_voxels + 1,):
        raise ValueError(f'bounds has shape {tuple(idx.bounds.shape)}, '
                         f'expected ({num_voxels + 1},)')
    if depth_flat.device != dev:
        raise ValueError('depth and feat must be on one device')
    out = torch.empty(num_voxels, C, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        KERNELS.launch(
            'bev_pool_fwd', depth_flat.data_ptr(), feat_flat.data_ptr(),
            idx.ranks_depth.data_ptr(), idx.ranks_feat.data_ptr(),
            idx.bounds.data_ptr(), out.data_ptr(), num_voxels, C,
            stream_ptr(dev))
    return out


def bev_pool(depth: torch.Tensor, feat: torch.Tensor, idx: PoolingIndex,
             grid: GridConfig) -> torch.Tensor:
    """Pool per-pixel depth-weighted features into the voxel grid.

    depth: (B, N, D, Hf, Wf) softmaxed depth; feat: (B, N, Hf, Wf, C).
    Returns (B, Z, Y, X, C) float32.  Plain version for CPU tensors, the CUDA
    kernel otherwise.
    """
    B = depth.shape[0]
    C = feat.shape[-1]
    gx, gy, gz = grid.grid_size
    num_voxels = B * gz * gy * gx
    depth_flat = depth.reshape(-1)
    feat_flat = feat.reshape(-1, C)
    if feat.device.type == 'cpu':
        out = bev_pool_plain(depth_flat, feat_flat, idx, num_voxels)
    else:
        out = bev_pool_cuda(depth_flat, feat_flat, idx, num_voxels)
    return out.reshape(B, gz, gy, gx, C)
