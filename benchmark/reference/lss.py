"""Cross-modal LSS view transformer (camera branch core), reference names.

Port of ``fusionocc_tpu/models/lss.py``.  Per (frame, view): one-hot the
min-pooled sparse LiDAR depth, encode it and the image feature, fuse them
with channel and spatial cross attention, predict depth logits, 2D
segmentation and a context feature, then lift-splat the softmaxed depth
times the context into the voxel grid with ``ops.bev_pool``.  In training
each view's depth input is zeroed with probability ``depth_drop_rate`` (a
0/1 mask per view, not rescaled, as JAX's), and the BatchNorms take batch
statistics.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import GridConfig, ViewTransformerConfig
from .layers import (ASPP, BasicBlock2D, BatchNorm, Conv2d, Linear, Mlp,
                         SELayer, conv_bn_relu, keep_mask)
from .bev_pool import PoolingIndex, bev_pool


def downsample_depth_onehot(sparse_depth: torch.Tensor, downsample: int,
                            grid: GridConfig, sid: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-pool sparse depth per patch and one-hot it into depth bins.

    sparse_depth: (B, N, H, W) metres, 0 = empty.  Returns the one-hot
    (B, N, h, w, D) float32 (all zeros where no depth) and the bin map
    (B, N, h, w) int32 (0 = empty, else 1..D).
    """
    B, N, H, W = sparse_depth.shape
    ds = downsample
    D = grid.num_depth_bins
    x = sparse_depth.float().reshape(B, N, H // ds, ds, W // ds, ds)
    x = torch.where(x == 0.0, torch.full_like(x, 1e5), x)
    x = x.amin(dim=(3, 5))
    lo, hi, step = grid.depth
    if sid:
        binf = torch.log(x) - torch.log(torch.tensor(lo, dtype=torch.float32))
        binf = (binf * (D - 1)
                / torch.log(torch.tensor((hi - 1.0) / lo, dtype=torch.float32))
                + 1.0)
    else:
        binf = (x - (lo - step)) / step
    binf = torch.where((binf < D + 1) & (binf >= 0.0), binf,
                       torch.zeros_like(binf))
    bins = binf.to(torch.int32)
    onehot = F.one_hot(bins.long(), D + 1)[..., 1:].float()
    return onehot, bins


class CrossModalFusion(nn.Module):
    """Channel + spatial cross attention between camera and depth features
    (NCHW; the reference's ``cross_model_fusion``)."""

    def __init__(self, mid: int, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha
        self.channel_mlp_c = nn.Sequential(Linear(mid, mid), nn.Sigmoid())
        self.channel_mlp_d = nn.Sequential(Linear(mid, mid), nn.Sigmoid())

        def spatial():
            return nn.Sequential(Conv2d(1, mid // 2, 1), nn.ReLU(),
                                 Conv2d(mid // 2, 1, 1), nn.ReLU())
        self.spatial_c = spatial()
        self.spatial_d = spatial()
        self.fuse_conv = conv_bn_relu(2 * mid, 2 * mid)

    def forward(self, fc, fd):
        C = fc.shape[1]
        w_c = self.channel_mlp_c(fc.mean(dim=(2, 3)))[..., None, None]
        w_d = self.channel_mlp_d(fd.mean(dim=(2, 3)))[..., None, None]
        fuse = self.fuse_conv(torch.cat([w_d * fc, w_c * fd], dim=1))
        zc = self.spatial_c(fuse[:, :C].mean(dim=1, keepdim=True))
        zd = self.spatial_d(fuse[:, C:].mean(dim=1, keepdim=True))
        return self.alpha * zd * fc + fc, self.alpha * zc * fd + fd


class DepthSegNet(nn.Module):
    """Depth distribution + 2D semantics + context head, conditioned on the
    batch-normed 27-dim camera vector through SE layers."""

    def __init__(self, cin: int, cfg: ViewTransformerConfig,
                 num_depth_bins: int):
        super().__init__()
        mid = cfg.mid_channels
        seg_ch = cfg.feature_channels // 2
        ctx_ch = cfg.feature_channels - seg_ch
        self.reduce_conv_depth = conv_bn_relu(cin, mid)
        self.reduce_conv_seg = conv_bn_relu(cin, mid)
        self.reduce_conv_context = conv_bn_relu(cin, mid)
        self.bn = BatchNorm(27)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer(mid)
        self.depth_conv = nn.Sequential(
            BasicBlock2D(mid), BasicBlock2D(mid),
            ASPP(mid, cfg.aspp_mid_channels), Conv2d(mid, num_depth_bins, 1))
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = Conv2d(mid, ctx_ch, 3, 1, 1)
        self.seg_mlp = Mlp(27, mid, mid)
        self.seg_se = SELayer(mid)
        self.seg_conv = nn.Sequential(Conv2d(mid, seg_ch, 3, 1, 1),
                                      BasicBlock2D(seg_ch))
        self.seg_out = Conv2d(seg_ch, cfg.seg_num_classes, 1)

    def forward(self, x, mlp_input):
        """x: (B', cin, h, w); mlp_input: (B', 27).  Returns depth logits
        (B', D, h, w), feature (B', C_feat, h, w), seg logits."""
        mi = self.bn(mlp_input.float()).to(x.dtype)
        x_c = self.reduce_conv_seg(x)
        x_d = self.reduce_conv_depth(x)
        x_cx = self.reduce_conv_context(x)
        seg = self.seg_se(x_c, self.seg_mlp(mi)[..., None, None])
        seg_feature = self.seg_conv(seg)
        seg_out = self.seg_out(seg_feature)
        ctx = self.context_se(x_cx, self.context_mlp(mi)[..., None, None])
        feature = torch.cat([seg_feature, self.context_conv(ctx)], dim=1)
        d = self.depth_se(x_d, self.depth_mlp(mi)[..., None, None])
        return self.depth_conv(d), feature, seg_out


class CrossModalLSS(nn.Module):
    """The cross-modal lift-splat view transformer."""

    def __init__(self, cfg: ViewTransformerConfig, grid: GridConfig,
                 cin: int):
        super().__init__()
        self.cfg, self.grid = cfg, grid
        mid = cfg.mid_channels
        D = grid.num_depth_bins
        self.img_reduce_conv = conv_bn_relu(cin, mid)
        self.depth_encoder = nn.Sequential(
            Conv2d(D, mid, 3, 1, 1, bias=False), BatchNorm(mid), nn.ReLU(),
            Conv2d(mid, mid, 3, 1, 1, bias=False), BatchNorm(mid), nn.ReLU())
        self.cross_model_fusion = CrossModalFusion(mid)
        self.further_fuse = BasicBlock2D(2 * mid)
        self.depth_seg_net = DepthSegNet(2 * mid, cfg, D)

    def forward(self, x, sparse_depth, mlp_input, pool_idx: PoolingIndex,
                pool_dtype=None):
        """x: (B, N, h, w, C_in) image features; sparse_depth: (B, N, H, W);
        mlp_input: (B, N, 27).  Returns the voxel feature (B, Z, Y, X, C)
        in ``pool_dtype`` (x's dtype by default; the index's B), the depth
        softmax (B, N, h, w, D) float32 and the seg logits
        (B, N, h, w, num_seg)."""
        cfg = self.cfg
        B, N, h, w, _ = x.shape
        D = self.grid.num_depth_bins
        onehot, _ = downsample_depth_onehot(sparse_depth, cfg.downsample,
                                            self.grid, sid=cfg.sid)
        if self.training and cfg.depth_drop_rate > 0:
            keep = keep_mask((B * N,), cfg.depth_drop_rate, onehot.device)
            onehot = onehot * keep.view(B, N, 1, 1, 1).float()
        di = onehot.to(x.dtype).reshape(B * N, h, w, D).permute(0, 3, 1, 2)
        img = x.reshape(B * N, h, w, x.shape[-1]).permute(0, 3, 1, 2)
        f_c = self.img_reduce_conv(img)
        f_d = self.depth_encoder(di)
        c2d, d2c = self.cross_model_fusion(f_c, f_d)
        fused = self.further_fuse(torch.cat([c2d, d2c], dim=1))
        depth_logits, feature, seg_out = self.depth_seg_net(
            fused, mlp_input.reshape(B * N, mlp_input.shape[-1]))
        depth = torch.softmax(depth_logits.float(), dim=1)  # (B*N, D, h, w)
        feature = feature.permute(0, 2, 3, 1).reshape(B, N, h, w,
                                                      feature.shape[1])
        voxel = bev_pool(depth.view(B, N, D, h, w), feature, pool_idx,
                         self.grid, out_dtype=pool_dtype or x.dtype)
        return (voxel,
                depth.permute(0, 2, 3, 1).reshape(B, N, h, w, D),
                seg_out.permute(0, 2, 3, 1).reshape(B, N, h, w,
                                                   seg_out.shape[1]))
