"""FusionOcc two-pass inference, reference module names.

Port of ``FusionOcc.__call__`` / ``predict`` of
``fusionocc_tpu/models/fusion_occ.py``.  Each temporal frame, oldest first,
goes through the camera branch (Swin -> FPN_LSS -> CrossModalLSS ->
bev_pool -> pre_process ResNet3D) with its own pose, so every frame lands
in the key-ego voxel grid.  The LiDAR sweep goes through the sparse encoder
(``models/lidar_encoder.py``), or is zeros when ``use_lidar`` is False (the
reference's image-only fallback).  The features are concatenated in the
order [adjacent frames..., key frame, lidar] and run through
CustomResNet3D -> LSSFPN3D -> final conv -> MLP predicter.

Streaming inference and ``batch_frames`` are not ported yet (ROADMAP Queue
A); ``check_supported`` refuses configurations the port does not run.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig, check_supported
from ..geometry import frustum_to_ego, get_mlp_input, make_frustum
from ..nn.layers import BatchNorm, Conv3d, LayerNorm, Linear
from ..nn.swin import SwinTransformer
from ..ops.bev_pool import PoolingIndex, prepare_pooling_index
from .fpn import FPN_LSS, LSSFPN3D, CustomResNet3D
from .lidar_encoder import SparseEncoder, SpConv
from .lss import CrossModalLSS


class Batch(NamedTuple):
    """One batch of tensors. F = num_frame (key + adjacent), N = cams."""
    imgs: torch.Tensor            # (B, F, N, H, W, 3)
    sensor2keyego: torch.Tensor   # (B, F, N, 4, 4) float32
    intrins: torch.Tensor         # (B, F, N, 3, 3)
    post_rots: torch.Tensor       # (B, F, N, 3, 3)
    post_trans: torch.Tensor      # (B, F, N, 3)
    bda: torch.Tensor             # (B, 3, 3)
    points: torch.Tensor          # (B, P, 5) padded ego-frame points
    points_mask: torch.Tensor     # (B, P) bool
    sparse_depth: torch.Tensor    # (B, N, H, W) metres (key frame)
    segs: Optional[torch.Tensor] = None             # (B, N, H, W) int32
    voxel_semantics: Optional[torch.Tensor] = None  # (B, X, Y, Z) int32
    mask_camera: Optional[torch.Tensor] = None      # (B, X, Y, Z) bool
    ego2global: Optional[torch.Tensor] = None       # (B, 4, 4)


def frame_pooling_index(cfg: ModelConfig, s2k, intrins, post_rots, post_trans,
                        bda) -> PoolingIndex:
    """Pooling index for one temporal frame's camera geometry.

    At inference the rig is fixed, so callers build it once per frame and
    pass it to ``forward`` / ``predict`` (the reference's ``accelerate``).
    """
    frustum = make_frustum(cfg.grid.depth, cfg.input_size, cfg.vt.downsample,
                           cfg.vt.sid, device=s2k.device)
    coor = frustum_to_ego(frustum, s2k, intrins, post_rots, post_trans, bda)
    return prepare_pooling_index(coor, cfg.grid)


def batch_pooling_indices(cfg: ModelConfig, batch: Batch):
    """Per-frame pooling indices of ``batch``, indexed by frame id."""
    return [frame_pooling_index(cfg, batch.sensor2keyego[:, f],
                                batch.intrins[:, f], batch.post_rots[:, f],
                                batch.post_trans[:, f], batch.bda)
            for f in range(cfg.num_frame)]


class FinalConv(nn.Module):
    """3x3x3 conv with bias (key ``final_conv.conv``) + ReLU, NCDHW."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv3d(c, c, 3, 1, 1, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


class FusionOcc(nn.Module):
    """FusionOcc.  Parameters are float32 on ``device`` (the card unless
    the caller asks for another); ``cfg.dtype`` is the compute dtype.
    """

    def __init__(self, cfg: ModelConfig, device='cuda'):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        sw = cfg.swin
        dims = sw.num_features
        occ = cfg.occ_channels
        with torch.device(device):
            self.img_backbone = SwinTransformer(sw)
            self.img_neck = FPN_LSS(
                dims[sw.out_indices[0]] + dims[sw.out_indices[1]],
                cfg.img_neck_out_channels)
            self.img_view_transformer = CrossModalLSS(
                cfg.vt, cfg.grid, cfg.img_neck_out_channels)
            self.pre_process_net = CustomResNet3D(
                cfg.vt.feature_channels, (cfg.img_channels,), (1,), (1,))
            if cfg.use_lidar:
                self.lidar_encoder = SparseEncoder(cfg.lidar, cfg.grid,
                                                   cfg.dtype, device)
            self.img_bev_encoder_backbone = CustomResNet3D(
                cfg.fusion_channels, cfg.bev_channels, cfg.bev_num_layer,
                cfg.bev_strides)
            self.img_bev_encoder_neck = LSSFPN3D(sum(cfg.bev_channels), occ)
            self.final_conv = FinalConv(occ)
            self.predicter = nn.Sequential(
                Linear(occ, occ * 2), nn.Softplus(),
                Linear(occ * 2, cfg.num_classes))
        self.to(device)     # buffers built from numpy start on the CPU

    def image_encoder(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) -> (B, N, h, w, C_neck)."""
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).to(self.cfg.dtype)
        feats = self.img_backbone(x)
        if self.cfg.swin.return_stereo_feat:
            feats = feats[1:]
        y = self.img_neck(feats)
        return y.reshape(B, N, y.shape[1], y.shape[2], -1)

    def _frame_voxel_feat(self, batch: Batch, fid: int,
                          pool_idx: Optional[PoolingIndex]):
        """One temporal frame through the camera branch."""
        mlp_input = get_mlp_input(
            batch.sensor2keyego[:, 0], batch.intrins[:, fid],
            batch.post_rots[:, fid], batch.post_trans[:, fid], batch.bda)
        x = self.image_encoder(batch.imgs[:, fid])
        if pool_idx is None:
            pool_idx = frame_pooling_index(
                self.cfg, batch.sensor2keyego[:, fid], batch.intrins[:, fid],
                batch.post_rots[:, fid], batch.post_trans[:, fid], batch.bda)
        voxel, depth, seg = self.img_view_transformer(
            x, batch.sparse_depth, mlp_input, pool_idx)
        return self.pre_process_net(voxel)[0], depth, seg

    def _lidar_feat(self, batch: Batch) -> torch.Tensor:
        """(B, Z, Y, X, C_lidar) in the compute dtype; zeros if image-only."""
        cfg = self.cfg
        if not cfg.use_lidar:
            gx, gy, gz = cfg.grid.grid_size
            return torch.zeros(batch.imgs.shape[0], gz, gy, gx,
                               cfg.lidar_out_channels, dtype=cfg.dtype,
                               device=batch.imgs.device)
        return self.lidar_encoder(batch.points,
                                  batch.points_mask).to(cfg.dtype)

    def forward(self, batch: Batch,
                pool_idxs: Optional[Sequence[PoolingIndex]] = None
                ) -> Dict[str, torch.Tensor]:
        """Two-pass inference.  pool_idxs: optional per-frame indices
        (``batch_pooling_indices``), else each is built in the call.

        Returns occ_logits (B, X, Y, Z, ncls) float32, the key frame's depth
        softmax (B, N, h, w, D) and seg logits (B, N, h, w, num_seg).
        """
        cfg = self.cfg
        voxel_feats = []            # order: [frame F-1 (oldest) ... frame 0]
        for fid in range(cfg.num_frame - 1, -1, -1):
            voxel, depth, seg = self._frame_voxel_feat(
                batch, fid, None if pool_idxs is None else pool_idxs[fid])
            voxel_feats.append(voxel)
        depth_key, seg_key = depth, seg      # the loop ends on the key frame
        fusion = torch.cat(voxel_feats + [self._lidar_feat(batch)], dim=-1)
        x = self.img_bev_encoder_neck(self.img_bev_encoder_backbone(fusion))
        x = self.final_conv(x.permute(0, 4, 1, 2, 3))     # (B, C, Z, Y, X)
        x = x.permute(0, 4, 3, 2, 1)                      # (B, X, Y, Z, C)
        h = F.softplus(self.predicter[0](x))
        logits = self.predicter[2](h.float())
        return {'occ_logits': logits, 'depth': depth_key, 'seg_logits': seg_key}

    @torch.inference_mode()
    def predict(self, batch: Batch,
                pool_idxs: Optional[Sequence[PoolingIndex]] = None
                ) -> torch.Tensor:
        """(B, X, Y, Z) uint8 class ids."""
        out = self(batch, pool_idxs=pool_idxs)
        return out['occ_logits'].argmax(dim=-1).to(torch.uint8)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (CPU): normal(0, 1/sqrt(fan_in)) for
    conv and linear weights, zero biases, truncated normal(0.02) bias
    tables, unit norm scales, and identity BatchNorm statistics."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, SpConv)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)
            if getattr(mod, 'bias', None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        if name.endswith('relative_position_bias_table'):
            p.copy_(torch.randn(p.shape, generator=generator).clamp(-2, 2)
                    * 0.02)
    return model
