"""The base LSS view transformers (BEVDet / BEVDepth / BEVStereo style).

Port of ``fusionocc_tpu/models/lss_base.py``:

- ``LSSViewTransformer``: one 1x1 conv predicts depth logits and a context
  feature; the depth softmax times the context is pooled into the voxel
  grid with ``ops.bev_pool`` (K1 on the card).
- ``DepthNet``: the camera-aware depth and context head, SE-conditioned on
  the batch-normed 27-dim camera vector, three BasicBlocks and ASPP; with
  ``stereo``, a plane-sweep cost volume brought down by two stride-2
  ConvBNs is concatenated before the blocks and reduced by a 1x1 conv.
- ``LSSViewTransformerBEVDepth``: ``DepthNet``-based lift-splat, stereo
  optional.
- ``stereo_cost_volume``: warps the previous frame's stage-0 feature onto
  the key frame's frustum at every candidate depth and softmaxes the
  negative L1 matching cost over depth: ``ops/plane_sweep.py``'s
  ``sweep_geometry`` then ``sweep`` (the plain ``plane_sweep`` on
  ``stereo_grid`` on the CPU, one kernel on the card), which
  ``models/bevstereo_occ.py`` also runs.

No preset uses the modules; they build camera-only BEVDet/BEVDepth-style
models from the port's layers (the ``bevdet_occ_stbase_stereo`` preset's
BEVStereo4D-Occ builds BEVDet's published stereo ``DepthNet`` in
``models/bevstereo_occ.py``, which departs from this one).  Module names follow the reference's BEVDepth
``DepthNet`` (``reduce_conv``, ``bn``, ``*_mlp``, ``*_se``,
``context_conv``, ``depth_conv``, ``cost_volumn_net``) and
``weights.lss_base_rules`` maps the JAX modules' parameters onto them.
Layouts are the JAX modules': image features (B, N, h, w, C), the voxel
feature (B, Z, Y, X, C), the depth softmax (B, N, h, w, D).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import GridConfig
from ..nn.layers import (ASPP, BasicBlock2D, BatchNorm, Conv2d, Mlp, SELayer,
                         conv_bn_relu)
from ..ops.bev_pool import PoolingIndex, bev_pool
from ..ops.plane_sweep import sweep, sweep_geometry


class DepthNet(nn.Module):
    """Camera-aware depth + context head (NCHW inside)."""

    def __init__(self, cin: int, mid: int, context_channels: int,
                 depth_channels: int, aspp_mid_channels: int = -1,
                 use_aspp: bool = True, stereo: bool = False):
        super().__init__()
        self.stereo = stereo
        self.reduce_conv = conv_bn_relu(cin, mid)
        self.bn = BatchNorm(27)
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = Conv2d(mid, context_channels, 1)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer(mid)
        if stereo:
            D = depth_channels
            self.cost_volumn_net = nn.Sequential(
                Conv2d(D, D, 3, 2, 1, bias=False), BatchNorm(D),
                Conv2d(D, D, 3, 2, 1, bias=False), BatchNorm(D))
            self.cv_downsample = Conv2d(mid + D, mid, 1)
        amc = aspp_mid_channels if aspp_mid_channels > 0 else mid
        self.depth_conv = nn.Sequential(
            BasicBlock2D(mid), BasicBlock2D(mid), BasicBlock2D(mid),
            *([ASPP(mid, amc)] if use_aspp else []),
            Conv2d(mid, depth_channels, 1))

    def forward(self, x, mlp_input, cost_volume: Optional[torch.Tensor] = None):
        """x (B', cin, h, w); mlp_input (..., 27) with B' rows; cost_volume
        (B', D, 4h, 4w) or None.  Returns depth logits (B', D, h, w) and
        the context (B', C_ctx, h, w)."""
        mi = self.bn(mlp_input.reshape(-1, mlp_input.shape[-1]).float()
                     ).to(x.dtype)
        x = self.reduce_conv(x)
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mi)[..., None, None]))
        d = self.depth_se(x, self.depth_mlp(mi)[..., None, None])
        if self.stereo and cost_volume is not None:
            cv = self.cost_volumn_net(cost_volume.to(x.dtype))
            d = self.cv_downsample(torch.cat([d, cv], dim=1))
        return self.depth_conv(d), context


def _lift_splat(depth_logits, feat, pool_idx: PoolingIndex,
                grid: GridConfig, B: int, N: int, dtype):
    """Depth softmax (fp32) times the fp32 feature, pooled: the voxel
    feature in ``dtype`` and the depth softmax (B, N, h, w, D)."""
    _, D, h, w = depth_logits.shape
    depth = torch.softmax(depth_logits.float(), dim=1)     # (BN, D, h, w)
    feat = feat.float().permute(0, 2, 3, 1).reshape(B, N, h, w, -1)
    voxel = bev_pool(depth.view(B, N, D, h, w), feat, pool_idx, grid,
                     out_dtype=dtype)
    return voxel, depth.permute(0, 2, 3, 1).reshape(B, N, h, w, D)


class LSSViewTransformer(nn.Module):
    """Plain lift-splat: one 1x1 conv -> (depth logits, context) ->
    bev_pool."""

    def __init__(self, grid: GridConfig, cin: int, out_channels: int):
        super().__init__()
        self.grid = grid
        self.depth_net = Conv2d(cin, grid.num_depth_bins + out_channels, 1)

    def forward(self, x, pool_idx: PoolingIndex):
        """x (B, N, h, w, C_in) -> (voxel (B, Z, Y, X, C_out) in x's
        dtype, depth softmax (B, N, h, w, D) fp32)."""
        B, N, h, w, _ = x.shape
        D = self.grid.num_depth_bins
        y = self.depth_net(x.reshape(B * N, h, w, -1).permute(0, 3, 1, 2))
        return _lift_splat(y[:, :D], y[:, D:], pool_idx, self.grid, B, N,
                           x.dtype)


class LSSViewTransformerBEVDepth(nn.Module):
    """DepthNet-based lift-splat (BEVDepth style), optional stereo cost
    volume."""

    def __init__(self, grid: GridConfig, cin: int, out_channels: int,
                 mid_channels: int = 256, aspp_mid_channels: int = 96,
                 stereo: bool = False):
        super().__init__()
        self.grid = grid
        self.depth_net = DepthNet(cin, mid_channels, out_channels,
                                  grid.num_depth_bins, aspp_mid_channels,
                                  stereo=stereo)

    def forward(self, x, mlp_input, pool_idx: PoolingIndex,
                cost_volume: Optional[torch.Tensor] = None):
        """x (B, N, h, w, C_in); mlp_input (B, N, 27); cost_volume (B*N,
        H, W, D) (``stereo_cost_volume``'s layout) or None.  Returns the
        voxel feature (B, Z, Y, X, C_out) in x's dtype and the depth
        softmax (B, N, h, w, D) fp32."""
        B, N, h, w, _ = x.shape
        cv = None if cost_volume is None else cost_volume.permute(0, 3, 1, 2)
        depth_logits, context = self.depth_net(
            x.reshape(B * N, h, w, -1).permute(0, 3, 1, 2), mlp_input, cv)
        return _lift_splat(depth_logits, context, pool_idx, self.grid, B, N,
                           x.dtype)


def stereo_cost_volume(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
                       frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                       intrins: torch.Tensor, post_rots: torch.Tensor,
                       post_trans: torch.Tensor, group_size: int = 4
                       ) -> torch.Tensor:
    """Plane-sweep stereo cost volume, in float32.

    prev/curr_feat: (B*N, hs, ws, C) stage-0 features; frustum (D, H, W, 3)
    at the cost-volume resolution; the poses map key-frame pixels into the
    previous (sweep) camera.  Returns (B*N, H, W, D), the softmax over depth
    of the negative L1 matching cost summed over channel groups of
    ``group_size``.
    """
    _, hs, ws, _ = curr_feat.shape
    # the input-image pixel extent of the stage-0 map
    geom = sweep_geometry(frustum, k2s_sensor, intrins, post_rots,
                          post_trans, hs * 4, ws * 4)
    return sweep(prev_feat, curr_feat, geom, group_size).permute(0, 2, 3, 1)
