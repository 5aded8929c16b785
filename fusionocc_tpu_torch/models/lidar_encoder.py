"""LiDAR branch: voxelization and the z-folded sparse 3D conv encoder.

Port of ``fusionocc_tpu/models/lidar_encoder.py``, the ``backend='zfold'``
path:

    points -> voxelize_mean -> conv_input (1x1) -> zfold_regroup
    -> stages 0 .. dense_from-1: SubM convs, then a stride-2 conv, each
       conv (ops/zwin_conv.py, kernel K3) masked to its super rows, then
       MaskedBatchNorm on the cell lane mask, then ReLU; with
       ``zwin_fuse`` in eval mode the three are one launch
       (``zwin_conv_epi``: the BatchNorm's affine, the ReLU and the lane
       mask in K3's epilogue), as the JAX package's eval path with
       ``zwin_fuse=True`` runs them; training always runs the chain, the
       conv through the ``ZwinConv`` autograd Function and the BatchNorm
       with batch statistics over the active cells
    -> stages dense_from ..: the masked dense tail (ops/dense_conv.py)
    -> conv_out (1x1) -> (B, Z, Y, X, C_out), the image voxel layout.

Each stage builds one neighbour table on its super grid, shared by its SubM
convs and its stride-2 conv; the same pass over it gives the stride-2
output's cell lane mask (``stage_indices_table`` with the lane mask).
Stage i keeps ``zfold_capacity[i]`` super rows at most, as the JAX package
does.  The index builds run on the whole batch at once; an encoder pass
waits for the card five times, once for each padded width (the voxels, the
super rows, each sparse stage's stride-2 output set), at any batch size.
The dense tail's BatchNorms stay unfused, as in JAX.  The encoder is built
in eval mode.

The last stage always runs in the dense tail.  It has no stride-2 conv, so
its active set is the one the stage before it made, and a masked dense SubM
conv computes on it what the sparse one would: ``dense_from`` = 4 (every
stage sparse in the JAX package) gives the result of 3.

Module and parameter names are the reference's (``conv_input.0``,
``encoder_layers.encoder_layer{i}.{j}.{0,1}``, ``conv_out.0``); conv weights
keep spconv2's (O, k, k, k, I) layout, so a reference ``state_dict`` loads
directly.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import GridConfig, ModelConfig, SparseEncoderConfig
from ..nn.layers import MaskedBatchNorm
from ..ops.dense_conv import dense_conv3d, dense_from_zfold, strided_out_mask
from ..ops.sparse_conv import (_downsample_keys, out_shape_strided,
                               sparse_conv1x1_apply, stage_indices_table)
from ..ops.voxelize import voxelize_mean
from ..ops.zfold import ZFoldVoxels, as_sparse, super_shape, zfold_regroup
from ..ops.zwin_conv import zwin_conv, zwin_conv_epi
from ..utils import profiling


class SpConv(nn.Module):
    """An spconv weight, (O, k, k, k, I); ``kernel()`` gives the JAX layout
    (27, I, O) for k = 3, (I, O) for k = 1."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, k, k, k, cin))

    def kernel(self) -> torch.Tensor:
        O, k = self.weight.shape[0], self.weight.shape[1]
        w = self.weight.reshape(O, k ** 3, -1).permute(1, 2, 0)
        return w[0] if k == 1 else w


class SparseConvBN(nn.Sequential):
    """A 3x3x3 conv (key ``0``), masked BN (key ``1``) and ReLU: the JAX
    package's ``SubMConvBN`` (stride 1) and ``SparseConvBNStride2``, in
    their z-folded and dense modes.  ``fuse`` runs the z-folded mode as one
    fused launch (``zwin_fuse``) in eval mode."""

    def __init__(self, cin: int, cout: int, stride: int, fuse: bool = False):
        super().__init__(SpConv(cin, cout, 3), MaskedBatchNorm(cout))
        self.stride, self.fuse = stride, fuse

    def zfold(self, feats, mask_out, nbr, lane_mask, f_in: int, f_out: int):
        """feats (B, S_in, f_in*Cin) -> (B, S_out, f_out*Cout); lane_mask
        is the output's cell lane mask (B, S_out, f_out)."""
        w = self[0].kernel()
        if self.fuse and not self.training:
            inv, shift = self[1].scale_shift()
            return zwin_conv_epi(feats, mask_out, nbr, w, f_in, f_out,
                                 self.stride, inv.repeat(f_out),
                                 shift.repeat(f_out), lane_mask)
        y = zwin_conv(feats, mask_out, nbr, w, f_in, f_out, self.stride)
        return F.relu(self[1](y, lane_mask))

    def dense(self, x, mask):
        """x (B, X, Y, Z, Cin) -> (B, X', Y', Z', Cout); mask is the
        output's active set."""
        return F.relu(self[1](
            dense_conv3d(x, self[0].kernel(), self.stride), mask))


class SparseEncoder(nn.Module):
    """Points (B, P, 5) + mask (B, P) -> dense (B, Z, Y, X, C_out).

    ``dtype`` is the compute dtype; parameters are float32 on ``device``.
    """

    def __init__(self, cfg: SparseEncoderConfig, grid: GridConfig,
                 dtype: torch.dtype = torch.float32, device='cuda'):
        super().__init__()
        self.cfg, self.grid, self.dtype = cfg, grid, dtype
        with torch.device(device):
            self.conv_input = nn.Sequential(
                SpConv(cfg.in_channels, cfg.base_channels, 1))
            layers, cin = {}, cfg.base_channels
            last = len(cfg.encoder_channels) - 1
            for i, blocks in enumerate(cfg.encoder_channels):
                convs = []
                for j, c in enumerate(blocks):
                    down = i < last and j == len(blocks) - 1
                    convs.append(SparseConvBN(cin, c, 2 if down else 1,
                                              cfg.zwin_fuse))
                    cin = c
                layers[f'encoder_layer{i + 1}'] = nn.Sequential(*convs)
            self.encoder_layers = nn.ModuleDict(layers)
            self.conv_out = nn.Sequential(
                SpConv(cin, cfg.output_channels, 1))
        # the spans of each stage's index build and convs (profiling.span)
        self.stage_spans = [(f'lidar.stage{i}.index', f'lidar.stage{i}.convs')
                            for i in range(len(cfg.encoder_channels))]
        self.eval()     # inference semantics until train() is called

    def forward(self, points: torch.Tensor,
                points_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cells = cfg.sparse_shape(self.grid)
        with profiling.span('lidar.voxelize'):
            sp = voxelize_mean(points, points_mask,
                               self.grid.point_cloud_range, cfg.voxel_size,
                               cells, cfg.voxel_capacity[0])
        feats = sparse_conv1x1_apply(sp.feats.to(self.dtype), sp.mask,
                                     self.conv_input[0].kernel())
        with profiling.span('lidar.regroup'):
            zf = zfold_regroup(sp._replace(feats=feats), cells,
                               cfg.zfold_capacity[0],
                               min(cfg.zfold, cells[2]))
        dense_from = min(cfg.dense_from, len(cfg.encoder_channels) - 1)
        for i in range(dense_from):
            layer = self.encoder_layers[f'encoder_layer{i + 1}']
            index_span, convs_span = self.stage_spans[i]
            sshape = super_shape(cells, zf.fold)
            cells = out_shape_strided(cells)
            f_out = min(cfg.zfold, cells[2])
            with profiling.span(index_span):
                nbr, ((oc, okeys, om, snbr, lane), _) = stage_indices_table(
                    as_sparse(zf), sshape, cfg.zfold_capacity[i + 1],
                    zf.lane_mask, f_out)
            with profiling.span(convs_span):
                f = zf.feats
                for conv in layer[:-1]:
                    f = conv.zfold(f, zf.mask, nbr, zf.lane_mask, zf.fold,
                                   zf.fold)
                f = layer[-1].zfold(f, om, snbr, lane, zf.fold, f_out)
            zf = ZFoldVoxels(f, oc, okeys, om, lane, f_out)
        with profiling.span('lidar.dense_tail'):
            return self._dense_tail(zf, cells, dense_from)

    def _dense_tail(self, zf: ZFoldVoxels, cells, start: int):
        """Masked dense convs for stages >= ``start``, then conv_out."""
        x, mask = dense_from_zfold(zf, cells, zf.feats.shape[-1] // zf.fold)
        for i in range(start, len(self.cfg.encoder_channels)):
            for conv in self.encoder_layers[f'encoder_layer{i + 1}']:
                if conv.stride == 2:
                    mask = strided_out_mask(mask)
                x = conv.dense(x, mask)
        # x is exact zero at inactive cells: conv_out needs no re-mask
        y = x @ self.conv_out[0].kernel().to(x.dtype)
        return y.permute(0, 3, 2, 1, 4)


def capacity_cuts(cfg: ModelConfig, points: torch.Tensor,
                  points_mask: torch.Tensor
                  ) -> List[Tuple[str, torch.Tensor, int]]:
    """The static cuts of the encoder's index builds on a padded cloud
    (B, P, 5): per cut its name, each sample's rows before it (B,) and its
    capacity, in the encoder's order: voxels at ``voxel_capacity[0]``
    (``voxelize_mean``), super rows at ``zfold_capacity[0]``
    (``zfold_regroup``), each sparse stage's stride-2 outputs at
    ``zfold_capacity[i + 1]`` (``stage_indices_table``).  Each count comes
    from the port's own builds run without the capacity, on the set the
    previous cut left; a cut keeps min(rows, capacity)."""
    lc, grid = cfg.lidar, cfg.grid
    cells = lc.sparse_shape(grid)
    fold = min(lc.zfold, cells[2])
    every = math.prod(cells)
    args = (points, points_mask, grid.point_cloud_range, lc.voxel_size,
            cells)
    sp = voxelize_mean(*args, lc.voxel_capacity[0])
    zf = zfold_regroup(sp, cells, lc.zfold_capacity[0], fold)
    cuts = [('voxels', voxelize_mean(*args, every).mask.sum(1),
             lc.voxel_capacity[0]),
            ('super rows', zfold_regroup(sp, cells, every // fold,
                                         fold).mask.sum(1),
             lc.zfold_capacity[0])]
    coords, mask = zf.coords, zf.mask
    for i in range(min(lc.dense_from, len(lc.encoder_channels) - 1)):
        shape = out_shape_strided(super_shape(cells, fold))
        cap = lc.zfold_capacity[i + 1]
        cuts.append((f'stage {i} stride-2 outputs', _downsample_keys(
            coords, mask, shape, math.prod(shape))[2].sum(1), cap))
        coords, _, mask = _downsample_keys(coords, mask, shape, cap)
        cells = out_shape_strided(cells)
        fold = min(lc.zfold, cells[2])
    return cuts
