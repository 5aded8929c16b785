"""FusionOcc, plain PyTorch: the reference the benchmark holds the port to.

A frozen copy of the port's model for one process, with the plain
versions in place of its kernels (``window_attn.py``, ``bev_pool.py``,
``zwin_conv.py``) and the port's module names, so one state dict loads
into both.  ``forward`` is two-pass inference (each temporal frame through
the camera branch with its own pose, the LiDAR sweep through the sparse
encoder or zeros when image-only, the head on [adjacent..., key, lidar]),
or in training mode the training forward (adjacent frames under
``no_grad``, random draws from the caller's ``layers.random_scope``).
``streaming_logits`` is one streamed frame: the cached previous frame's
camera voxel feature warped into this frame's ego frame, or the frame's
own where the cache is not valid.  Every index is built here.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .bev_pool import PoolingIndex, prepare_pooling_index
from .config import ModelConfig
from .fpn import FPN_LSS, LSSFPN3D, CustomResNet3D
from .geometry import frustum_to_ego, get_mlp_input, make_frustum
from .grid_sample import grid_sample_2d
from .layers import Conv3d, Linear
from .lidar_encoder import SparseEncoder
from .lss import CrossModalLSS
from .swin import SwinTransformer


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
    """Pooling index of one temporal frame's camera geometry."""
    frustum = make_frustum(cfg.grid.depth, cfg.input_size, cfg.vt.downsample,
                           cfg.vt.sid, device=s2k.device)
    coor = frustum_to_ego(frustum, s2k, intrins, post_rots, post_trans, bda)
    return prepare_pooling_index(coor, cfg.grid)


class FinalConv(nn.Module):
    """3x3x3 conv with bias (key ``final_conv.conv``) + ReLU, NCDHW."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv3d(c, c, 3, 1, 1, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


class FusionOcc(nn.Module):
    """FusionOcc.  Parameters are float32 on ``device``; ``cfg.dtype`` is
    the compute dtype.  Built in eval mode."""

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
        self.eval()

    def image_encoder(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) -> (B, N, h, w, C_neck)."""
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).to(self.cfg.dtype)
        feats = self.img_backbone(x)
        if self.cfg.swin.return_stereo_feat:
            feats = feats[1:]
        y = self.img_neck(feats)
        return y.reshape(B, N, *y.shape[1:])

    def _frame_voxel_feat(self, imgs_f, s2k_f, s2k_key, intrin_f, post_rot_f,
                          post_tran_f, bda, sparse_depth):
        """One temporal frame through the camera branch, pooled with the
        frame's own pose ``s2k_f``; the MLP input takes the key frame's
        ``s2k_key``.  Returns the voxel feature (B, Z, Y, X, C_img), the
        depth softmax and the seg logits."""
        mlp_input = get_mlp_input(s2k_key, intrin_f, post_rot_f, post_tran_f,
                                  bda)
        x = self.image_encoder(imgs_f)
        pool_idx = frame_pooling_index(self.cfg, s2k_f, intrin_f, post_rot_f,
                                       post_tran_f, bda)
        voxel, depth, seg = self.img_view_transformer(
            x, sparse_depth, mlp_input, pool_idx)
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

    def _head(self, fusion: torch.Tensor) -> torch.Tensor:
        """The fused (B, Z, Y, X, C) volume through the BEV trunk, the final
        conv and the predicter: (B, X, Y, Z, ncls) float32 logits."""
        x = self.img_bev_encoder_neck(self.img_bev_encoder_backbone(fusion))
        x = self.final_conv(x.permute(0, 4, 1, 2, 3))     # (B, C, Z, Y, X)
        x = x.permute(0, 4, 3, 2, 1)                      # (B, X, Y, Z, C)
        h = F.softplus(self.predicter[0](x))
        return self.predicter[2](h.float())

    def forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Two-pass inference, or in training mode the training forward:
        occ_logits (B, X, Y, Z, ncls) float32, the key frame's depth
        softmax (B, N, h, w, D) and seg logits (B, N, h, w, num_seg)."""
        cfg = self.cfg
        voxel_feats = []        # order: [frame F-1 (oldest) ... frame 0]
        for fid in range(cfg.num_frame - 1, -1, -1):
            # adjacent frames pass no gradient
            with (torch.no_grad() if fid else contextlib.nullcontext()):
                voxel, depth_key, seg_key = self._frame_voxel_feat(
                    batch.imgs[:, fid], batch.sensor2keyego[:, fid],
                    batch.sensor2keyego[:, 0], batch.intrins[:, fid],
                    batch.post_rots[:, fid], batch.post_trans[:, fid],
                    batch.bda, batch.sparse_depth)
            voxel_feats.append(voxel)   # the loop ends on the key frame
        logits = self._head(
            torch.cat(voxel_feats + [self._lidar_feat(batch)], dim=-1))
        return {'occ_logits': logits, 'depth': depth_key,
                'seg_logits': seg_key}

    def _shift_bev(self, feat: torch.Tensor, dst2src: torch.Tensor
                   ) -> torch.Tensor:
        """Warp a (B, Z, Y, X, C) voxel feature from its source ego frame
        onto the destination ego grid (a planar x-y warp; z is carried):
        each destination cell centre goes through ``dst2src`` (B, 4, 4) and
        is sampled bilinearly, in float32, from the source cell centres."""
        grid = self.cfg.grid
        B, Z, Y, X, C = feat.shape
        dev = feat.device
        lo = torch.tensor(grid.lower_bound, dtype=torch.float32, device=dev)
        step = torch.tensor(grid.interval, dtype=torch.float32, device=dev)
        xs = lo[0] + (torch.arange(X, device=dev) + 0.5) * step[0]
        ys = lo[1] + (torch.arange(Y, device=dev) + 0.5) * step[1]
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')      # (Y, X)
        pts = torch.stack([gx, gy, torch.zeros_like(gx),
                           torch.ones_like(gx)], -1)        # (Y, X, 4)
        src = torch.einsum('bij,yxj->byxi', dst2src.float(), pts)
        # normalised source coordinates, align_corners over cell centres
        nx = (src[..., 0] - lo[0]) / step[0] - 0.5
        ny = (src[..., 1] - lo[1]) / step[1] - 0.5
        sample = torch.stack([nx / (X - 1) * 2.0 - 1.0,
                              ny / (Y - 1) * 2.0 - 1.0], -1)  # (B, Y, X, 2)
        flat = feat.permute(0, 4, 1, 2, 3).reshape(B, C * Z, Y, X)
        warped = grid_sample_2d(flat, sample).reshape(B, C, Z, Y, X)
        return warped.permute(0, 2, 3, 4, 1).to(feat.dtype)

    def _fused_logits(self, prev_feat, dst2src, valid, voxel, lidar):
        """Warp the cached features, take the frame's own feature where the
        cache is not valid, fuse as [prev, key, lidar] and run the head."""
        warped = self._shift_bev(prev_feat, dst2src)
        prev = torch.where(valid[:, None, None, None, None], warped, voxel)
        return self._head(torch.cat([prev, voxel, lidar], dim=-1))

    def camera_voxel(self, batch: Batch) -> torch.Tensor:
        """Frame 0's camera voxel feature (B, Z, Y, X, C): what a streamed
        frame leaves in the cache."""
        return self._frame_voxel_feat(
            batch.imgs[:, 0], batch.sensor2keyego[:, 0],
            batch.sensor2keyego[:, 0], batch.intrins[:, 0],
            batch.post_rots[:, 0], batch.post_trans[:, 0], batch.bda,
            batch.sparse_depth)[0]

    def streaming_logits(self, batch: Batch, prev_voxel: torch.Tensor,
                         prev_ego2global: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
        """One streamed frame's occupancy logits (B, X, Y, Z, ncls): frame
        0 of ``batch`` with one camera pass, the adjacent feature the
        previous frame's ``prev_voxel`` warped from its pose
        ``prev_ego2global`` into this frame's where ``valid`` (B,), the
        frame's own feature elsewhere."""
        voxel = self.camera_voxel(batch)
        dst2src = (torch.linalg.inv(prev_ego2global.float())
                   @ batch.ego2global.float())
        return self._fused_logits(prev_voxel, dst2src, valid, voxel,
                                  self._lidar_feat(batch))
