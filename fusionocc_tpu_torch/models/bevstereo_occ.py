"""BEVStereo4D-Occ, BEVDet-Occ's camera-only stereo baseline, on the port's
path.

BEVDet (github.com/HuangJunJie2017/BEVDet, branch dev2.1):
``configs/bevdet_occ/bevdet-occ-stbase-4d-stereo-512x1408-24e.py``; the
detector ``BEVStereo4DOCC`` (``mmdet3d/models/detectors/bevdet_occ.py``) on
``BEVStereo4D`` (``detectors/bevdet.py``); ``DepthNet`` and
``LSSViewTransformerBEVStereo`` (``necks/view_transformer.py``).  The
``bevdet_occ_stbase_stereo`` preset selects it (``configs.build_model``).

It stands beside ``FusionOcc`` on their shared base, ``models.fusion_occ.
OccModel``: the image encoder (Swin-B with K2, FPN_LSS), the pooling index
and K1, the 27-number camera vector, the ``pre_process`` ResNet3D, the
trunk (CustomResNet3D, LSSFPN3D), the final conv and the predicter, and the
entry points ``forward`` and ``predict`` (``predict(batch, pool_idxs=...)``
returns (B, X, Y, Z) uint8).  A ``Batch`` carries three frames
(``input_frames``): f = 0 the key frame, 1 the adjacent one, 2 the stereo
reference frame.

The equations, frames oldest first (f = 2, 1, 0):

- frame 2: only ``S_2 = stage0(patch_embed(I_2))`` (``SwinTransformer.
  stereo_feat``, BEVDet's ``extract_stereo_ref_feat``);
- frames 1 and 0: ``x_f, S_f = Swin(I_f)`` then FPN_LSS;
  ``CV_f = cost_volume(S_f, S_{f+1}, k2s_f)`` with ``k2s_f =
  inv(s2k_{f+1}) @ s2k_f`` (frame f's cameras into frame f+1's, in float64
  as BEVDet's ``curr2adjsensor``); ``(depth_logits, ctx) = DepthNet(x_f,
  mlp(s2k_0, ...), CV_f)``; ``V_f = pre_process(bev_pool(softmax(
  depth_logits) x ctx, index_f))``, each frame pooled with its own pose;
- ``logits = predicter(final_conv(trunk(cat[V_1, V_0])))``: FusionOcc's
  order, oldest first, which is BEVDet's ``bev_feat_list`` order.

``cost_volume(curr, prev, k2s)`` is BEVDet's plane sweep with
``group_size`` = 4 and the invalid ``bias`` = 5, on the frustum at stride
``cv_downsample`` = 4 (``ops/plane_sweep.py`` sets it out): the
per-camera pieces of the projection are composed once a call
(``sweep_geometry``, span ``camera.stereo.grid``); the sweep itself, grid
included, is one kernel on the card (``fusionocc::plane_sweep``).

``DepthNet`` (stereo): ``x = reduce_conv(x)`` (3x3 conv with bias, BN,
ReLU); ``ctx = context_conv(context_se(x, context_mlp(bn(mlp_in))))``;
``d = depth_se(x, depth_mlp(bn(mlp_in)))``; ``cv = cost_volumn_net(CV)``,
two ``Conv2d(D, D, 3, stride 2, pad 1)`` (bias) each with a BN, 1/4 ->
1/16 resolution; ``depth_conv(cat[d, cv])``: ``BasicBlock(mid + D ->
mid)`` whose residual is a bare ``Conv2d(mid + D, mid, 1)``, two
``BasicBlock(mid)``, ``ASPP(mid, aspp_mid)``, ``Conv2d(mid, D, 1)``.  It
departs from ``lss_base.DepthNet`` (the JAX package's form: a separate 1x1
``cv_downsample``, bias-free convs, no invalid bias).  The cost volume
passes no gradient (BEVDet computes it under ``no_grad``).

Module names are BEVDet's ``state_dict`` names (``weights.
bevstereo_depth_net_names``).  Spans: ``camera.stereo_ref`` (frame 2's
stage 0), ``camera.stereo`` with ``camera.stereo.grid`` (the per-camera
pieces) and ``camera.stereo.cost_volume`` (the sweep), ``camera.depth_net``
inside ``camera.view_transformer``.  The stereo path reads nothing from the
card: its inverses are ``inv_ex`` and the frustum is a buffer.  No LiDAR,
no ``batch_frames`` fold and no streaming: the configuration is
camera-only and BEVDet evaluates it two-pass.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..config import GridConfig, ModelConfig, ViewTransformerConfig
from ..geometry import get_mlp_input, make_frustum
from ..nn.layers import (ASPP, BasicBlock2D, BatchNorm, Conv2d, Mlp, SELayer)
from ..ops.bev_pool import PoolingIndex, bev_pool
from ..ops.plane_sweep import SweepGeometry, sweep, sweep_geometry
from ..utils import profiling
from .fusion_occ import Batch, OccModel, frame_pooling_index


class StereoDepthNet(nn.Module):
    """BEVDet's ``DepthNet`` with ``stereo=True``, ``use_dcn=False``
    (NCHW inside)."""

    def __init__(self, cin: int, mid: int, context_channels: int,
                 depth_channels: int, aspp_mid_channels: int):
        super().__init__()
        D = depth_channels
        self.reduce_conv = nn.Sequential(Conv2d(cin, mid, 3, 1, 1),
                                         BatchNorm(mid), nn.ReLU())
        self.context_conv = Conv2d(mid, context_channels, 1)
        self.bn = BatchNorm(27)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer(mid)
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer(mid)
        self.cost_volumn_net = nn.Sequential(
            Conv2d(D, D, 3, 2, 1), BatchNorm(D),
            Conv2d(D, D, 3, 2, 1), BatchNorm(D))
        self.depth_conv = nn.Sequential(
            BasicBlock2D(mid + D, mid, downsample=Conv2d(mid + D, mid, 1)),
            BasicBlock2D(mid), BasicBlock2D(mid),
            ASPP(mid, aspp_mid_channels), Conv2d(mid, D, 1))

    def forward(self, x, mlp_input, cost_volume):
        """x (B', cin, h, w); mlp_input (..., 27) with B' rows; cost_volume
        (B', D, 4h, 4w).  Returns depth logits (B', D, h, w) and the
        context (B', C_ctx, h, w), in x's dtype."""
        mi = self.bn(mlp_input.reshape(-1, mlp_input.shape[-1]).float()
                     ).to(x.dtype)
        x = self.reduce_conv(x)
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mi)[..., None, None]))
        d = self.depth_se(x, self.depth_mlp(mi)[..., None, None])
        cv = self.cost_volumn_net(cost_volume.to(x.dtype))
        return self.depth_conv(torch.cat([d, cv], dim=1)), context


class CostVolume(nn.Module):
    """The plane sweep (``ops.plane_sweep.sweep``) with BEVDet's group size
    and invalid bias; no parameters.  Its own module so that the sweep can
    be timed by forward hooks."""

    def __init__(self, depth_bins: int, group_size: int, bias: float):
        super().__init__()
        self.depth_bins, self.group_size, self.bias = (depth_bins,
                                                       group_size, bias)

    def forward(self, curr: torch.Tensor, prev: torch.Tensor,
                geometry: SweepGeometry) -> torch.Tensor:
        """curr, prev (B*N, H, W, C) stage-0 features; the cameras'
        ``sweep_geometry`` with ``depth_bins`` planes.  Returns (B*N, D, H,
        W) float32."""
        return sweep(prev, curr, geometry, self.group_size, self.bias)


class LSSViewTransformerBEVStereo(nn.Module):
    """BEVDet's stereo lift-splat: ``depth_net`` (``StereoDepthNet``), the
    depth softmax times the context pooled with K1, and the frustum at the
    cost volume's stride (``cv_frustum``, a buffer out of the state
    dict)."""

    def __init__(self, cfg: ViewTransformerConfig, grid: GridConfig,
                 input_size, cin: int, cv_downsample: int, group_size: int,
                 bias: float):
        super().__init__()
        self.grid = grid
        D = grid.num_depth_bins
        self.depth_net = StereoDepthNet(cin, cfg.mid_channels,
                                        cfg.feature_channels, D,
                                        cfg.aspp_mid_channels)
        self.cost_volume = CostVolume(D, group_size, bias)
        self.register_buffer('cv_frustum', make_frustum(
            grid.depth, input_size, cv_downsample, cfg.sid), persistent=False)

    def forward(self, x, mlp_input, cost_volume, pool_idx: PoolingIndex):
        """x (B, N, h, w, C_in); mlp_input (B, N, 27); cost_volume (B*N, D,
        4h, 4w).  Returns the voxel feature (B, Z, Y, X, C) in x's dtype
        and the depth softmax (B, N, h, w, D) float32."""
        B, N, h, w, _ = x.shape
        D = self.grid.num_depth_bins
        with profiling.span('camera.depth_net'):
            depth_logits, context = self.depth_net(
                x.reshape(B * N, h, w, -1).permute(0, 3, 1, 2), mlp_input,
                cost_volume)
        depth = torch.softmax(depth_logits.float(), dim=1)  # (B*N, D, h, w)
        feature = context.permute(0, 2, 3, 1).reshape(B, N, h, w, -1)
        voxel = bev_pool(depth.view(B, N, D, h, w), feature, pool_idx,
                         self.grid, out_dtype=x.dtype)
        return voxel, depth.permute(0, 2, 3, 1).reshape(B, N, h, w, D)


class BEVStereo4DOcc(OccModel):
    """BEVStereo4D-Occ on ``device`` (``OccModel``)."""

    # BEVStereo4D's and its DepthNet's fixed numbers, under BEVDet's names
    cv_downsample = 4
    group_size = 4
    bias = 5.0

    def __init__(self, cfg: ModelConfig, device='cuda'):
        if cfg.use_lidar:
            raise NotImplementedError(
                'BEVStereo4D-Occ is camera-only (use_lidar=False)')
        super().__init__(cfg, device)

    def _view_transformer(self) -> nn.Module:
        cfg = self.cfg
        return LSSViewTransformerBEVStereo(
            cfg.vt, cfg.grid, cfg.input_size, cfg.img_neck_out_channels,
            self.cv_downsample, self.group_size, self.bias)

    @property
    def input_frames(self) -> int:
        """The key frame, the ``num_adj`` adjacent ones and the stereo
        reference frame (BEVStereo4D's ``extra_ref_frames`` = 1)."""
        return self.cfg.num_frame + 1

    def _stereo_frame(self, batch: Batch, fid: int, prev: torch.Tensor,
                      pool_idx: Optional[PoolingIndex]):
        """Frame ``fid`` through the camera branch with its cost volume
        against the stage-0 feature ``prev`` of frame fid + 1.  Returns
        the voxel feature (B, Z, Y, X, C), the depth softmax and the
        frame's own stage-0 feature (the next frame's ``prev``)."""
        vt = self.img_view_transformer
        s2k = batch.sensor2keyego
        intrin, rot = batch.intrins[:, fid], batch.post_rots[:, fid]
        tran = batch.post_trans[:, fid]
        mlp_input = get_mlp_input(s2k[:, 0], intrin, rot, tran, batch.bda)
        x, curr = self.image_encoder(batch.imgs[:, fid], stereo=True)
        with profiling.span('camera.stereo'):
            with profiling.span('camera.stereo.grid'):
                k2s = (torch.linalg.inv_ex(s2k[:, fid + 1].double())[0]
                       @ s2k[:, fid].double()).float()
                geometry = sweep_geometry(
                    vt.cv_frustum, k2s, intrin, rot, tran,
                    curr.shape[1] * self.cv_downsample,
                    curr.shape[2] * self.cv_downsample)
            with profiling.span('camera.stereo.cost_volume'), \
                    torch.no_grad():
                cv = vt.cost_volume(curr, prev, geometry)
        if pool_idx is None:
            with profiling.span('camera.pooling_index'):
                pool_idx = frame_pooling_index(self.cfg, s2k[:, fid], intrin,
                                               rot, tran, batch.bda)
        with profiling.span('camera.view_transformer'):
            voxel, depth = vt(x, mlp_input, cv, pool_idx)
        with profiling.span('camera.pre_process'):
            return self.pre_process_net(voxel)[0], depth, curr

    def _outputs(self, batch: Batch,
                 pool_idxs: Optional[Sequence[PoolingIndex]] = None
                 ) -> Dict[str, torch.Tensor]:
        """occ_logits (B, X, Y, Z, ncls) float32 and the key frame's depth
        softmax (B, N, h, w, D).  ``pool_idxs``: optional indices of frames
        0 .. num_frame - 1 (the reference frame pools nothing).  The frames
        are chained (each cost volume reads the next older frame), so
        there is no ``batch_frames`` fold."""
        cfg = self.cfg
        with profiling.span('camera.stereo_ref'), torch.no_grad():
            prev = self.img_backbone.stereo_feat(     # (B*N, H/4, W/4, C0)
                batch.imgs[:, cfg.num_frame].flatten(0, 1).to(cfg.dtype))
        voxel_feats = []            # order: [frame F-1 (oldest) ... frame 0]
        for fid in range(cfg.num_frame - 1, -1, -1):
            # adjacent frames pass no gradient
            with (torch.no_grad() if fid else contextlib.nullcontext()):
                voxel, depth_key, prev = self._stereo_frame(
                    batch, fid, prev,
                    None if pool_idxs is None else pool_idxs[fid])
            voxel_feats.append(voxel)
        return {'occ_logits': self._head(torch.cat(voxel_feats, dim=-1)),
                'depth': depth_key}
