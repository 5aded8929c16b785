"""BEVStereo4D-Occ, plain PyTorch: the reference the stereo cell holds the
port to.

BEVDet-Occ's camera-only stereo baseline (BEVDet dev2.1:
``configs/bevdet_occ/bevdet-occ-stbase-4d-stereo-512x1408-24e.py``,
``BEVStereo4DOCC`` on ``BEVStereo4D``, ``DepthNet`` and
``LSSViewTransformerBEVStereo``), written from the published code on the
frozen reference layers (``swin``, ``fpn``, ``geometry``, ``bev_pool``,
``grid_sample``, ``layers``), with the port's module names, which are
BEVDet's, so one state dict loads into both.  Float32 with TF32 off unless
the caller asks for the configuration's precision; nothing of the port or
of the JAX package is imported.

A batch holds three frames, f = 0 the key, 1 the adjacent, 2 the stereo
reference.  Frames run oldest first: frame 2 gives only its stage-0
feature (patch embedding and stage 0's blocks, BEVDet's
``extract_stereo_ref_feat``); frames 1 and 0 each run Swin-B and FPN_LSS,
a plane-sweep cost volume against the stage-0 feature of the frame before
them (``cost_volume``), the stereo ``DepthNet``, the depth softmax times
the context pooled with the frame's own pose, and the ``pre_process``
ResNet3D; the trunk, the final conv and the predicter take
[frame 1, frame 0].  The plane sweep goes through ``counting.kernel_call``
with its frozen formula (``plane_sweep_flops``), so the FLOPs counted are
the work it needs.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .bev_pool import bev_pool
from .config import ModelConfig
from .counting import kernel_call
from .fpn import FPN_LSS, LSSFPN3D, CustomResNet3D
from .fusion_occ import Batch, FinalConv, frame_pooling_index
from .geometry import get_mlp_input, make_frustum
from .grid_sample import grid_sample_2d
from .layers import (ASPP, BasicBlock2D, BatchNorm, Conv2d, Linear, Mlp,
                     SELayer)
from .swin import SwinTransformer

EXTRA_REF_FRAMES = 1    # BEVStereo4D's extra_ref_frames
CV_DOWNSAMPLE = 4       # the cost volume's stride (cv_frustum, cv_downsample)
GROUP_SIZE = 4          # calculate_cost_volumn's group_size
INVALID_BIAS = 5.0      # DepthNet's bias (depthnet_cfg bias=5.)


def plane_sweep_flops(C: int, BN: int, D: int, h: int, w: int) -> int:
    """The frozen count of one volume: per hypothesis and channel, the
    bilinear sample's 4 taps (4 multiplies, 3 adds), a difference, an
    absolute value and an add: 10 C BN D h w."""
    return 10 * C * BN * D * h * w


class DownsampleBlock(nn.Module):
    """mmdet BasicBlock from ``cin`` to ``cout`` channels whose residual is
    the bare 1x1 conv ``downsample`` (with bias)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.downsample = Conv2d(cin, cout, 1)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.downsample(x))


class DepthNet(nn.Module):
    """BEVDet's ``DepthNet(in, mid, context, D, use_dcn=False,
    stereo=True, bias=5, aspp_mid_channels)``."""

    def __init__(self, cin: int, mid: int, context: int, D: int,
                 aspp_mid: int):
        super().__init__()
        self.reduce_conv = nn.Sequential(Conv2d(cin, mid, 3, 1, 1),
                                         BatchNorm(mid), nn.ReLU())
        self.context_conv = Conv2d(mid, context, 1)
        self.bn = BatchNorm(27)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer(mid)
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer(mid)
        self.cost_volumn_net = nn.Sequential(
            Conv2d(D, D, 3, 2, 1), BatchNorm(D),
            Conv2d(D, D, 3, 2, 1), BatchNorm(D))
        self.depth_conv = nn.Sequential(
            DownsampleBlock(mid + D, mid), BasicBlock2D(mid),
            BasicBlock2D(mid), ASPP(mid, aspp_mid), Conv2d(mid, D, 1))

    def forward(self, x, mlp_input, cost_volume):
        """x (BN, cin, h, w) in the compute dtype; mlp_input (BN, 27);
        cost_volume (BN, D, 4h, 4w) float32.  Returns the depth logits and
        the context, NCHW."""
        mi = self.bn(mlp_input.float()).to(x.dtype)
        x = self.reduce_conv(x)
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mi)[..., None, None]))
        depth = self.depth_se(x, self.depth_mlp(mi)[..., None, None])
        cv = self.cost_volumn_net(cost_volume.to(x.dtype))
        return self.depth_conv(torch.cat([depth, cv], dim=1)), context


class ViewTransformer(nn.Module):
    """``LSSViewTransformerBEVStereo``'s parameters: its ``depth_net``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        vt = cfg.vt
        self.depth_net = DepthNet(cfg.img_neck_out_channels, vt.mid_channels,
                                  vt.feature_channels,
                                  cfg.grid.num_depth_bins,
                                  vt.aspp_mid_channels)


def sweep_grid(cfg: ModelConfig, k2s, intrins, post_rots, post_trans):
    """BEVDet's ``gen_grid``: (BN, D*h, w, 2) sampling positions of the
    stride-4 frustum's points in the previous camera, float32."""
    B, N = intrins.shape[:2]
    frustum = make_frustum(cfg.grid.depth, cfg.input_size, CV_DOWNSAMPLE,
                           cfg.vt.sid, device=intrins.device)
    D, h, w, _ = frustum.shape
    hi, wi = cfg.input_size
    pts = frustum[None, None] - post_trans.view(B, N, 1, 1, 1, 3)
    pts = (torch.linalg.inv(post_rots).view(B, N, 1, 1, 1, 3, 3)
           @ pts[..., None])
    pts = torch.cat([pts[..., :2, :] * pts[..., 2:3, :], pts[..., 2:3, :]],
                    dim=5)
    combine = k2s[..., :3, :3] @ torch.linalg.inv(intrins)
    pts = combine.view(B, N, 1, 1, 1, 3, 3) @ pts
    pts = pts + k2s[..., :3, 3].view(B, N, 1, 1, 1, 3, 1)
    behind = pts[..., 2, 0] < 1e-3
    pts = intrins.view(B, N, 1, 1, 1, 3, 3) @ pts
    uv = pts[..., :2, :] / pts[..., 2:3, :]
    uv = (post_rots[..., :2, :2].view(B, N, 1, 1, 1, 2, 2) @ uv)[..., 0]
    uv = uv + post_trans[..., :2].view(B, N, 1, 1, 1, 2)
    px = uv[..., 0] / (wi - 1.0) * 2.0 - 1.0
    py = uv[..., 1] / (hi - 1.0) * 2.0 - 1.0
    px = torch.where(behind, torch.full_like(px, -2.0), px)
    py = torch.where(behind, torch.full_like(py, -2.0), py)
    return torch.stack([px, py], dim=-1).view(B * N, D * h, w, 2)


def sweep_plain(prev, curr, grid, D: int):
    """BEVDet's ``calculate_cost_volumn`` on NCHW float32 features:
    softmax over depth of minus the grouped L1 matching cost, the invalid
    bias where the last group's first sampled channel is exactly 0."""
    BN, C, h, w = curr.shape
    cost = 0
    for g in range(C // GROUP_SIZE):
        part = slice(g * GROUP_SIZE, (g + 1) * GROUP_SIZE)
        warp = grid_sample_2d(prev[:, part], grid).view(BN, -1, D, h, w)
        cost = cost + (curr[:, part, None] - warp).abs().sum(dim=1)
    invalid = warp[:, 0] == 0
    cost = torch.where(invalid, cost + INVALID_BIAS, cost)
    return torch.softmax(-cost, dim=1)


def cost_volume(cfg: ModelConfig, curr, prev, k2s, intrins, post_rots,
                post_trans):
    """curr, prev (BN, h, w, C) stage-0 features -> (BN, D, h, w)."""
    grid = sweep_grid(cfg, k2s, intrins, post_rots, post_trans)
    D = cfg.grid.num_depth_bins
    BN, h, w, C = curr.shape
    c = curr.permute(0, 3, 1, 2).float()
    p = prev.permute(0, 3, 1, 2).float()
    return kernel_call(lambda p_, c_, g_: sweep_plain(p_, c_, g_, D),
                       lambda: plane_sweep_flops(C, BN, D, h, w), p, c, grid)


class BEVStereo4DOcc(nn.Module):
    """BEVStereo4D-Occ.  Parameters are float32 on ``device``; ``cfg.dtype``
    is the compute dtype.  Built in eval mode."""

    def __init__(self, cfg: ModelConfig, device='cuda'):
        super().__init__()
        self.cfg = cfg
        sw = cfg.swin
        dims = sw.num_features
        occ = cfg.occ_channels
        with torch.device(device):
            self.img_backbone = SwinTransformer(sw)
            self.img_neck = FPN_LSS(
                dims[sw.out_indices[0]] + dims[sw.out_indices[1]],
                cfg.img_neck_out_channels)
            self.img_view_transformer = ViewTransformer(cfg)
            self.pre_process_net = CustomResNet3D(
                cfg.vt.feature_channels, (cfg.img_channels,), (1,), (1,))
            self.img_bev_encoder_backbone = CustomResNet3D(
                cfg.fusion_channels, cfg.bev_channels, cfg.bev_num_layer,
                cfg.bev_strides)
            self.img_bev_encoder_neck = LSSFPN3D(sum(cfg.bev_channels), occ)
            self.final_conv = FinalConv(occ)
            self.predicter = nn.Sequential(
                Linear(occ, occ * 2), nn.Softplus(),
                Linear(occ * 2, cfg.num_classes))
        self.to(device)     # buffers built from numpy start on the CPU
        self.eval()

    def stereo_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) -> stage 0's output (BN, H/4, W/4, C0), walked
        through the backbone's modules as ``extract_stereo_ref_feat``."""
        B, N, H, W, _ = imgs.shape
        bb = self.img_backbone
        x = imgs.reshape(B * N, H, W, 3).to(self.cfg.dtype)
        x = bb.patch_embed.projection(x.permute(0, 3, 1, 2))
        hw = (x.shape[2], x.shape[3])
        x = bb.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for blk in bb.stages[0].blocks:
            x = blk(x, hw, None)
        return x.view(B * N, *hw, x.shape[-1])

    def image_encoder(self, imgs: torch.Tensor):
        """(B, N, H, W, 3) -> the neck's (B, N, h, w, C) and the stage-0
        feature (BN, H/4, W/4, C0)."""
        B, N, H, W, _ = imgs.shape
        feats = self.img_backbone(
            imgs.reshape(B * N, H, W, 3).to(self.cfg.dtype))
        y = self.img_neck(feats[1:])
        return y.reshape(B, N, *y.shape[1:]), feats[0]

    def frame(self, batch: Batch, fid: int, prev: torch.Tensor):
        """Frame ``fid`` against the stage-0 feature ``prev`` of frame
        fid + 1: (voxel feature (B, Z, Y, X, C), depth softmax, the frame's
        stage-0 feature)."""
        cfg = self.cfg
        s2k = batch.sensor2keyego
        intrin, rot = batch.intrins[:, fid], batch.post_rots[:, fid]
        tran, bda = batch.post_trans[:, fid], batch.bda
        x, curr = self.image_encoder(batch.imgs[:, fid])
        B, N, h, w, _ = x.shape
        D = cfg.grid.num_depth_bins
        k2s = (torch.linalg.inv(s2k[:, fid + 1].double())
               @ s2k[:, fid].double()).float()
        with torch.no_grad():
            cv = cost_volume(cfg, curr, prev, k2s, intrin, rot, tran)
        mlp_input = get_mlp_input(s2k[:, 0], intrin, rot, tran, bda)
        depth_logits, context = self.img_view_transformer.depth_net(
            x.reshape(B * N, h, w, -1).permute(0, 3, 1, 2),
            mlp_input.reshape(B * N, -1), cv)
        depth = torch.softmax(depth_logits.float(), dim=1)
        feat = context.permute(0, 2, 3, 1).reshape(B, N, h, w, -1)
        idx = frame_pooling_index(cfg, s2k[:, fid], intrin, rot, tran, bda)
        voxel = bev_pool(depth.view(B, N, D, h, w), feat, idx, cfg.grid,
                         out_dtype=x.dtype)
        return (self.pre_process_net(voxel)[0],
                depth.permute(0, 2, 3, 1).reshape(B, N, h, w, D), curr)

    def forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """occ_logits (B, X, Y, Z, ncls) float32 and the key frame's depth
        softmax (B, N, h, w, D)."""
        cfg = self.cfg
        with torch.no_grad():
            prev = self.stereo_feat(batch.imgs[:, cfg.num_frame])
        feats = []
        for fid in range(cfg.num_frame - 1, -1, -1):
            with (torch.no_grad() if fid else contextlib.nullcontext()):
                voxel, depth, prev = self.frame(batch, fid, prev)
            feats.append(voxel)
        x = self.img_bev_encoder_neck(self.img_bev_encoder_backbone(
            torch.cat(feats, dim=-1)))
        x = self.final_conv(x.permute(0, 4, 1, 2, 3))     # (B, C, Z, Y, X)
        x = x.permute(0, 4, 3, 2, 1)                      # (B, X, Y, Z, C)
        h = F.softplus(self.predicter[0](x))
        return {'occ_logits': self.predicter[2](h.float()), 'depth': depth}
