"""FusionOcc, reference module names, and ``OccModel``, what it shares
with BEVStereo4D-Occ (``models/bevstereo_occ.py``).

Port of ``FusionOcc.__call__`` / ``predict`` and the streaming entry points
of ``fusionocc_tpu/models/fusion_occ.py``.

``OccModel`` builds the shared modules under the reference's names and in
its order (``img_backbone``, ``img_neck``, the subclass's
``_view_transformer()``, ``pre_process_net``, its ``_lidar_encoder()`` if
any, then the head) and runs ``forward`` / ``predict`` over the subclass's
``_outputs``.  The model is built in eval mode, and every ``predict*`` runs
with eval semantics whatever mode it is in (JAX passes ``train=False``);
only the trainer (``train/loop.py``) calls ``train()``.  In training,
``forward`` runs the frames one by one, the adjacent frames under
``torch.no_grad`` (JAX's ``stop_gradient``: their BatchNorms still take
batch statistics and update, frame F-1 first and the key frame last), and
with ``remat_bev`` the BEV trunk under ``nn.layers.checkpoint``; its random
draws come from the caller's ``nn.layers.random_scope``.

Two-pass inference (``forward`` / ``predict``): each temporal frame, oldest
first, goes through the camera branch (Swin -> FPN_LSS -> CrossModalLSS ->
bev_pool -> pre_process ResNet3D) with its own pose, so every frame lands
in the key-ego voxel grid; with ``batch_frames`` all frames go through one
camera pass at batch B*F instead.  The LiDAR sweep goes through the sparse
encoder (``models/lidar_encoder.py``), or is zeros when ``use_lidar`` is
False (the reference's image-only fallback).  The features are concatenated
in the order [adjacent frames..., key frame, lidar] and run through the head
(``_head``: CustomResNet3D -> LSSFPN3D -> final conv -> MLP predicter).

Streaming inference (``predict_streaming``, ``predict_streaming_scan``,
``predict_streaming_batch``) runs one camera pass per frame and takes the
adjacent frame's feature from a cache (``StreamingState``): the previous
frame's camera voxel feature, warped into the new ego frame (``_shift_bev``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig, check_supported
from ..geometry import frustum_to_ego, get_mlp_input, make_frustum
from ..nn.layers import BatchNorm, Conv3d, LayerNorm, Linear, checkpoint
from ..nn.swin import SwinTransformer
from ..ops.bev_pool import PoolingIndex, prepare_pooling_index
from ..ops.grid_sample import grid_sample_2d
from ..utils import profiling
from .fpn import FPN_LSS, LSSFPN3D, CustomResNet3D
from .lidar_encoder import SparseEncoder, SpConv
from .lss import CrossModalLSS


class Batch(NamedTuple):
    """One batch of tensors. F = the model's ``input_frames``, N = cams."""
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


def frame_ego_points(cfg: ModelConfig, s2k, intrins, post_rots, post_trans,
                     bda) -> torch.Tensor:
    """A frame's camera frustum in the key ego frame, (B, N, D, h, w, 3)."""
    frustum = make_frustum(cfg.grid.depth, cfg.input_size, cfg.vt.downsample,
                           cfg.vt.sid, device=s2k.device)
    return frustum_to_ego(frustum, s2k, intrins, post_rots, post_trans, bda)


def frame_pooling_index(cfg: ModelConfig, s2k, intrins, post_rots, post_trans,
                        bda) -> PoolingIndex:
    """Pooling index for one temporal frame's camera geometry.

    At inference the rig is fixed, so callers build it once per frame and
    pass it to ``forward`` / ``predict`` (the reference's ``accelerate``).
    """
    return prepare_pooling_index(frame_ego_points(
        cfg, s2k, intrins, post_rots, post_trans, bda), cfg.grid)


def batch_pooling_indices(cfg: ModelConfig, batch: Batch):
    """Per-frame pooling indices of ``batch``, indexed by frame id."""
    return [frame_pooling_index(cfg, batch.sensor2keyego[:, f],
                                batch.intrins[:, f], batch.post_rots[:, f],
                                batch.post_trans[:, f], batch.bda)
            for f in range(cfg.num_frame)]


class StreamingState(NamedTuple):
    """Temporal cache of streaming inference: the previous key frame's
    camera voxel feature (in its own ego frame) and its ego pose."""
    voxel_feat: torch.Tensor    # (B, Z, Y, X, C_img) in cfg.dtype
    ego2global: torch.Tensor    # (B, 4, 4) float32
    valid: torch.Tensor         # (B,) bool, False at scene starts


def map_batch(fn, batch: Batch) -> Batch:
    """``fn`` applied to every tensor of ``batch`` (absent fields stay
    None)."""
    return Batch(*(None if a is None else fn(a) for a in batch))


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """Batches stacked on a new leading (time) axis: (T, B, ...)."""
    return Batch(*(None if a[0] is None else torch.stack(a)
                   for a in zip(*batches)))


def batched_frames_pooling_index(cfg: ModelConfig, batch: Batch
                                 ) -> PoolingIndex:
    """Pooling index of ``forward(batch_frames=True)``: the (B, F) frames
    folded into one batch of B*F, each with its own pose and ``bda``
    repeated per frame (the fold order of ``_batched_frame_feats``)."""
    def fold(a):
        return a.reshape((-1,) + a.shape[2:])
    return frame_pooling_index(
        cfg, fold(batch.sensor2keyego), fold(batch.intrins),
        fold(batch.post_rots), fold(batch.post_trans),
        batch.bda.repeat_interleave(batch.sensor2keyego.shape[1], dim=0))


def streaming_fold_pooling_index(cfg: ModelConfig, stacked: Batch,
                                 chunk: int, cam_chunk: int = 0
                                 ) -> PoolingIndex:
    """Pooling index of ``predict_streaming_batch``: the key-frame geometry
    of the first n stacked (T, B, ...) frames folded into one batch of n*B,
    where n is the camera fold (``cam_chunk`` when it is below ``chunk``,
    else ``chunk``).  The rig is the same in every frame, so one index
    serves every block."""
    n = cam_chunk if 0 < cam_chunk < chunk else chunk

    def fold(a):
        return a[:n].reshape((-1,) + a.shape[2:])
    return frame_pooling_index(
        cfg, fold(stacked.sensor2keyego)[:, 0], fold(stacked.intrins)[:, 0],
        fold(stacked.post_rots)[:, 0], fold(stacked.post_trans)[:, 0],
        fold(stacked.bda))


class FinalConv(nn.Module):
    """3x3x3 conv with bias (key ``final_conv.conv``) + ReLU, NCDHW."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv3d(c, c, 3, 1, 1, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


def _inference(fn):
    """Run a ``predict*`` method under ``torch.inference_mode`` with eval
    semantics, whatever mode the model is in, inside an entry span of its
    name (``utils/profiling.py``)."""
    name = fn.__name__

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with (torch.inference_mode(), self.eval_semantics(),
              profiling.span(name, entry=True)):
            return fn(self, *args, **kwargs)
    return run


class OccModel(nn.Module):
    """The shared modules and entry points: float32 parameters on
    ``device`` (the card by default), ``cfg.dtype`` the compute dtype."""

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
            self.img_view_transformer = self._view_transformer()
            self.pre_process_net = CustomResNet3D(
                cfg.vt.feature_channels, (cfg.img_channels,), (1,), (1,))
            lidar = self._lidar_encoder(device)
            if lidar is not None:
                self.lidar_encoder = lidar
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

    def _lidar_encoder(self, device) -> Optional[nn.Module]:
        """The LiDAR branch (``lidar_encoder``), if the model has one."""
        return None

    @property
    def input_frames(self) -> int:
        """Temporal frames a ``Batch`` carries: key and adjacent ones."""
        return self.cfg.num_frame

    @contextlib.contextmanager
    def eval_semantics(self):
        """Every module in eval mode inside; the modes restored after."""
        modes = [(m, m.training) for m in self.modules()]
        self.eval()
        try:
            yield
        finally:
            for m, mode in modes:
                m.training = mode

    def image_encoder(self, imgs: torch.Tensor, stereo: bool = False):
        """(B, N, H, W, 3) -> (B, N, h, w, C_neck); with ``stereo`` also
        Swin's stage-0 feature (B*N, H/4, W/4, C0), which
        ``return_stereo_feat`` must then give."""
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).to(self.cfg.dtype)
        with profiling.span('camera.backbone'):
            feats = self.img_backbone(x)
        if self.cfg.swin.return_stereo_feat:
            stereo_feat, feats = feats[0], feats[1:]
        elif stereo:
            raise ValueError('the stereo feature needs '
                             'swin.return_stereo_feat')
        with profiling.span('camera.neck'):
            y = self.img_neck(feats)
        y = y.reshape(B, N, *y.shape[1:])
        return (y, stereo_feat) if stereo else y

    def local_targets(self, batch: Batch) -> Batch:
        """The targets of what the training ``forward`` returns."""
        return batch

    def _trunk(self, fusion: torch.Tensor) -> torch.Tensor:
        """The BEV trunk, (B, Z, Y, X, C) in and out."""
        return self.img_bev_encoder_neck(self.img_bev_encoder_backbone(fusion))

    def _final_conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_conv(x)

    def _head(self, fusion: torch.Tensor) -> torch.Tensor:
        """The fused (B, Z, Y, X, C) volume through the BEV trunk (in
        training with ``remat_bev``, checkpointed), the final conv and the
        predicter: (B, X, Y, Z, ncls) float32 logits."""
        with profiling.span('head'):
            with profiling.span('head.trunk'):
                if (self.training and self.cfg.remat_bev
                        and torch.is_grad_enabled()):
                    x = checkpoint(self._trunk, fusion)
                else:
                    x = self._trunk(fusion)
            with profiling.span('head.final'):
                x = self._final_conv(x.permute(0, 4, 1, 2, 3))  # NCDHW
                x = x.permute(0, 4, 3, 2, 1)              # (B, X, Y, Z, C)
                h = F.softplus(self.predicter[0](x))
                return self.predicter[2](h.float())

    def forward(self, batch: Batch,
                pool_idxs: Optional[Sequence[PoolingIndex]] = None,
                **fold) -> Dict[str, torch.Tensor]:
        """Two-pass inference, or in training mode the training forward:
        ``_outputs``.  pool_idxs: optional per-frame indices
        (``batch_pooling_indices``), else each is built in the call;
        ``fold``: the model's own options of ``_outputs``."""
        with profiling.span('forward', entry=True):
            return self._outputs(batch, pool_idxs, **fold)

    @_inference
    def predict(self, batch: Batch,
                pool_idxs: Optional[Sequence[PoolingIndex]] = None,
                **fold) -> torch.Tensor:
        """(B, X, Y, Z) uint8 class ids."""
        out = self._outputs(batch, pool_idxs, **fold)
        return out['occ_logits'].argmax(dim=-1).to(torch.uint8)


class FusionOcc(OccModel):
    """FusionOcc on ``device`` (``OccModel``)."""

    def _view_transformer(self) -> nn.Module:
        cfg = self.cfg
        return CrossModalLSS(cfg.vt, cfg.grid, cfg.img_neck_out_channels)

    def _lidar_encoder(self, device) -> Optional[nn.Module]:
        cfg = self.cfg
        return (SparseEncoder(cfg.lidar, cfg.grid, cfg.dtype, device)
                if cfg.use_lidar else None)

    def _frame_voxel_feat(self, imgs_f, s2k_f, s2k_key, intrin_f, post_rot_f,
                          post_tran_f, bda, sparse_depth,
                          pool_idx: Optional[PoolingIndex] = None):
        """One temporal frame (or a fold of frames) through the camera
        branch, pooled with the frame's own pose ``s2k_f``; the MLP input
        takes the key frame's ``s2k_key``.  Returns the voxel feature
        (B, Z, Y, X, C_img), the depth softmax and the seg logits."""
        mlp_input = get_mlp_input(s2k_key, intrin_f, post_rot_f, post_tran_f,
                                  bda)
        x = self.image_encoder(imgs_f)
        if pool_idx is None:
            with profiling.span('camera.pooling_index'):
                pool_idx = frame_pooling_index(self.cfg, s2k_f, intrin_f,
                                               post_rot_f, post_tran_f, bda)
        with profiling.span('camera.view_transformer'):
            voxel, depth, seg = self.img_view_transformer(
                x, sparse_depth, mlp_input, pool_idx)
        with profiling.span('camera.pre_process'):
            return self.pre_process_net(voxel)[0], depth, seg

    def _key_images(self, t: torch.Tensor, B: int, F_: int) -> torch.Tensor:
        """The key frame's (B, N, ...) of a camera pass over B*F_ frames."""
        return t.reshape((B, F_) + t.shape[1:])[:, 0]

    def _batched_frame_feats(self, batch: Batch,
                             pool_idx: Optional[PoolingIndex] = None):
        """All F temporal frames through one camera pass at batch B*F.
        Every frame's MLP input takes the key frame's pose, and the key
        frame's sparse depth serves every frame.  Returns the voxel features
        in the order [frame F-1 ... frame 0] and frame 0's depth and seg."""
        B, F_, N, H, W, _ = batch.imgs.shape

        def fold(a):
            return a.reshape((B * F_,) + a.shape[2:])
        key = batch.sensor2keyego[:, :1].expand_as(batch.sensor2keyego)
        voxel, depth, seg = self._frame_voxel_feat(
            fold(batch.imgs), fold(batch.sensor2keyego), fold(key),
            fold(batch.intrins), fold(batch.post_rots),
            fold(batch.post_trans), batch.bda.repeat_interleave(F_, dim=0),
            fold(batch.sparse_depth[:, None].expand(B, F_, N, H, W)),
            pool_idx)
        voxel = voxel.reshape((B, F_) + voxel.shape[1:])
        feats = [voxel[:, f] for f in range(F_ - 1, -1, -1)]
        return (feats, self._key_images(depth, B, F_),
                self._key_images(seg, B, F_))

    def _lidar_feat(self, batch: Batch) -> torch.Tensor:
        """(B, Z, Y, X, C_lidar) in the compute dtype; zeros if image-only."""
        cfg = self.cfg
        if not cfg.use_lidar:
            gx, gy, gz = cfg.grid.grid_size
            return torch.zeros(batch.imgs.shape[0], gz, gy, gx,
                               cfg.lidar_out_channels, dtype=cfg.dtype,
                               device=batch.imgs.device)
        with profiling.span('lidar'):
            return self.lidar_encoder(batch.points,
                                      batch.points_mask).to(cfg.dtype)

    def _outputs(self, batch: Batch,
                 pool_idxs: Optional[Sequence[PoolingIndex]] = None,
                 batch_frames: bool = False,
                 pool_idx_folded: Optional[PoolingIndex] = None
                 ) -> Dict[str, torch.Tensor]:
        """occ_logits (B, X, Y, Z, ncls) float32, the key frame's depth
        softmax (B, N, h, w, D) and seg logits (B, N, h, w, num_seg).
        batch_frames (eval only, as in JAX): all temporal frames in one
        camera pass, with the optional index ``pool_idx_folded``
        (``batched_frames_pooling_index``)."""
        cfg = self.cfg
        if batch_frames and cfg.num_frame > 1 and not self.training:
            voxel_feats, depth_key, seg_key = self._batched_frame_feats(
                batch, pool_idx_folded)
        else:
            voxel_feats = []        # order: [frame F-1 (oldest) ... frame 0]
            for fid in range(cfg.num_frame - 1, -1, -1):
                # adjacent frames pass no gradient (JAX's stop_gradient)
                with (torch.no_grad() if fid else contextlib.nullcontext()):
                    voxel, depth_key, seg_key = self._frame_voxel_feat(
                        batch.imgs[:, fid], batch.sensor2keyego[:, fid],
                        batch.sensor2keyego[:, 0], batch.intrins[:, fid],
                        batch.post_rots[:, fid], batch.post_trans[:, fid],
                        batch.bda, batch.sparse_depth,
                        None if pool_idxs is None else pool_idxs[fid])
                voxel_feats.append(voxel)   # the loop ends on the key frame
        logits = self._head(
            torch.cat(voxel_feats + [self._lidar_feat(batch)], dim=-1))
        return {'occ_logits': logits, 'depth': depth_key,
                'seg_logits': seg_key}

    # -- streaming inference with a temporal BEV cache ----------------------
    def init_streaming_state(self, batch_size: int = 1) -> StreamingState:
        """An empty cache on the model's device."""
        cfg = self.cfg
        dev = next(self.parameters()).device
        gx, gy, gz = cfg.grid.grid_size
        return StreamingState(
            torch.zeros(batch_size, gz, gy, gx, cfg.img_channels,
                        dtype=cfg.dtype, device=dev),
            torch.eye(4, device=dev).expand(batch_size, 4, 4).clone(),
            torch.zeros(batch_size, dtype=torch.bool, device=dev))

    def _check_streaming(self, frames: Batch) -> None:
        if frames.ego2global is None:
            raise ValueError('streaming needs ego2global in the batch')
        if self.cfg.num_adj != 1:
            raise ValueError('the streaming cache assumes one adjacent frame, '
                             f'got num_adj={self.cfg.num_adj}')

    def _shift_bev(self, feat: torch.Tensor, dst2src: torch.Tensor
                   ) -> torch.Tensor:
        """Warp a (B, Z, Y, X, C) voxel feature from its source ego frame
        onto the destination ego grid (a planar x-y warp; z is carried):
        each destination cell centre goes through ``dst2src`` (B, 4, 4) and
        is sampled bilinearly, in float32, from the source cell centres."""
        grid = self.cfg.grid
        B, Z, Y, X, C = feat.shape
        dev = feat.device
        with profiling.wait('warp.constant'):
            lo = torch.tensor(grid.lower_bound, dtype=torch.float32,
                              device=dev)
        with profiling.wait('warp.constant'):
            step = torch.tensor(grid.interval, dtype=torch.float32,
                                device=dev)
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
        with profiling.span('stream.warp'):
            warped = self._shift_bev(prev_feat, dst2src)
        prev = torch.where(valid[:, None, None, None, None], warped, voxel)
        return self._head(torch.cat([prev, voxel, lidar], dim=-1))

    @_inference
    def predict_streaming(self, batch: Batch, state: StreamingState,
                          pool_idx: Optional[PoolingIndex] = None,
                          reset: Optional[torch.Tensor] = None):
        """One frame with one camera pass (frame 0 of ``batch``), the
        adjacent feature taken from the cache warped into this frame's ego
        frame.  Where the cache is not valid (a scene start, or ``reset``
        (B,) bool set) the frame's own feature stands in for it.

        pool_idx: the key frame's pooling index (``frame_pooling_index``),
        else built in the call.  Returns (pred (B, X, Y, Z) uint8, outputs,
        new_state).  The streaming glue (the pose inverse, ``valid`` and
        ``reset``) never waits on the card; the warp waits twice (its two
        constants copied from the host), the LiDAR encoder five times, once
        per padded width of its index builds (``models/lidar_encoder.py``),
        and building ``pool_idx`` in the call six times (the frustum copied
        from the host, two matrix inverses, the two constants of
        ``ops/bev_pool.prepare_pooling_index`` and ``long_runs``'
        ``nonzero``).  Each is a ``utils/profiling.wait`` site.
        """
        self._check_streaming(batch)
        valid = state.valid if reset is None else state.valid & ~reset
        voxel, depth, seg = self._frame_voxel_feat(
            batch.imgs[:, 0], batch.sensor2keyego[:, 0],
            batch.sensor2keyego[:, 0], batch.intrins[:, 0],
            batch.post_rots[:, 0], batch.post_trans[:, 0], batch.bda,
            batch.sparse_depth, pool_idx)
        pose = batch.ego2global.float()
        dst2src = torch.linalg.inv_ex(state.ego2global.float())[0] @ pose
        logits = self._fused_logits(state.voxel_feat, dst2src, valid, voxel,
                                    self._lidar_feat(batch))
        pred = logits.argmax(dim=-1).to(torch.uint8)
        new_state = StreamingState(voxel, pose, torch.ones_like(valid))
        return pred, {'occ_logits': logits, 'depth': depth,
                      'seg_logits': seg}, new_state

    @_inference
    def predict_streaming_scan(self, frames: Batch, state: StreamingState,
                               resets: Optional[torch.Tensor] = None,
                               pool_idx: Optional[PoolingIndex] = None):
        """``predict_streaming`` over T frames, threading the cache.

        frames: a Batch whose tensors have a leading (T, B, ...) time axis;
        resets: optional (T, B) bool.  Returns (preds (T, B, X, Y, Z) uint8,
        final state).
        """
        preds = []
        for t in range(frames.imgs.shape[0]):
            pred, _, state = self.predict_streaming(
                map_batch(lambda a: a[t], frames), state, pool_idx,
                None if resets is None else resets[t])
            preds.append(pred)
        return torch.stack(preds), state

    @_inference
    def predict_streaming_batch(self, frames: Batch, state: StreamingState,
                                resets: Optional[torch.Tensor] = None,
                                pool_idx: Optional[PoolingIndex] = None,
                                chunk: int = 4, cam_chunk: int = 0):
        """Streaming over T frames with time folded into the batch.

        The cache is the previous frame's camera feature, which this pass
        computes for every frame, so within a block of ``chunk`` frames
        ``prev[t] = warp(voxel[t-1])`` has no serial dependence: the LiDAR
        and camera branches and the head run at batch chunk*B.  Blocks carry
        (last voxel feature, last pose, valid).  The same math as
        ``predict_streaming_scan``.

        frames: (T, B, ...) tensors, T % chunk == 0; resets: optional
        (T, B) bool.  cam_chunk: 0 or ``chunk`` runs the camera branch at
        chunk*B; a divisor of ``chunk`` below it runs it in microbatches of
        cam_chunk*B.  pool_idx: the index on the camera fold's geometry
        (``streaming_fold_pooling_index``), else built per microbatch.
        Returns (preds (T, B, X, Y, Z) uint8, final state).
        """
        self._check_streaming(frames)
        T, B = frames.imgs.shape[0], state.valid.shape[0]
        n = cam_chunk if 0 < cam_chunk < chunk else chunk
        if T % chunk or chunk % n:
            raise ValueError(f'T={T} must be a multiple of chunk={chunk}, '
                             f'and chunk of cam_chunk={cam_chunk}')
        if resets is None:
            resets = torch.zeros(T, B, dtype=torch.bool,
                                 device=state.valid.device)
        prev_voxel = state.voxel_feat
        prev_pose = state.ego2global.float()
        prev_valid = state.valid
        always = torch.ones(chunk - 1, B, dtype=torch.bool,
                            device=state.valid.device)

        def fold(a):
            return a.reshape((chunk * B,) + a.shape[2:])
        preds = []
        for t0 in range(0, T, chunk):
            fb = map_batch(lambda a: fold(a[t0:t0 + chunk]), frames)
            lidar = self._lidar_feat(fb)
            cam = (fb.imgs[:, 0], fb.sensor2keyego[:, 0], fb.intrins[:, 0],
                   fb.post_rots[:, 0], fb.post_trans[:, 0], fb.bda,
                   fb.sparse_depth)
            voxel = torch.cat([
                self._frame_voxel_feat(imgs, s2k, s2k, intr, rot, tran, bda,
                                       sd, pool_idx)[0]
                for imgs, s2k, intr, rot, tran, bda, sd in zip(
                    *(a.split(n * B) for a in cam))])
            vox_t = voxel.reshape((chunk, B) + voxel.shape[1:])
            pose = frames.ego2global[t0:t0 + chunk].float()  # (chunk, B, 4, 4)
            prev_feat = torch.cat([prev_voxel[None], vox_t[:-1]])
            pp = torch.cat([prev_pose[None], pose[:-1]])
            pv = torch.cat([prev_valid[None], always]) & ~resets[t0:t0 + chunk]
            dst2src = torch.linalg.inv_ex(pp)[0] @ pose
            logits = self._fused_logits(fold(prev_feat), fold(dst2src),
                                        fold(pv), voxel, lidar)
            pred = logits.argmax(dim=-1).to(torch.uint8)
            preds.append(pred.reshape((chunk, B) + pred.shape[1:4]))
            prev_voxel, prev_pose = vox_t[-1], pose[-1]
            prev_valid = torch.ones_like(state.valid)
        return torch.cat(preds), StreamingState(
            prev_voxel, prev_pose, torch.ones_like(state.valid))


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


@torch.no_grad()
def spread_weights(model: nn.Module, generator: torch.Generator
                   ) -> nn.Module:
    """``init_weights``, then every conv and linear weight times sqrt(2) (He
    gain) and the rows of the predicter's last layer centred.  With
    ``init_weights`` alone every voxel takes one class: its fan-in scale
    halves the variance at each ReLU, so the logits vary between voxels by
    about 1e-3 of their spread between classes, which the constant part of
    the softplus gives.  These weights give many classes, so comparisons of
    argmax maps between inference modes are not trivial."""
    init_weights(model, generator)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, SpConv)):
            mod.weight.mul_(2 ** 0.5)
    w = model.predicter[2].weight
    w.sub_(w.mean(dim=1, keepdim=True))
    return model
