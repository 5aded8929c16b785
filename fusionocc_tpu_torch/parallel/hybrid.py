"""FusionOcc under the hybrid (data, spatial) mesh.

``HybridFusionOcc(cfg, hybrid_mesh(n_data, n_spatial), device=...)`` is
``FusionOcc`` with the JAX package's ``mesh`` field: each process holds its
data rank's samples (``HybridMesh.shard``) and the steps that the JAX
package leaves to XLA's partitioner are written out:

- the camera images: rank (d, s) takes block s of its B*N images (the
  constraint on the image batch, ``fusionocc_tpu/models/fusion_occ.py:
  178-179``); Swin-B, FPN_LSS and CrossModalLSS run on those, and K1 pools
  them into a partial float32 volume of every sample (an index of the
  rank's images, ``prepare_pooling_index(images=)``);
- the partial volumes are summed over the spatial group (K1 is additive
  over cameras; the sum is differentiable) and cast once, as one process
  casts K1's float32 sums; ``pre_process_net`` then runs replicated on
  the whole volume, as does the LiDAR encoder, each with its BatchNorms
  over the data group (``HybridMesh.replicated``): the streaming cache and
  ``_shift_bev`` see the whole pooled feature;
- the fused volume's Y axis (``:299-301``): each rank runs the trunk, the
  final conv and the predicter on its Y rows (``parallel/spatial.py``).

``forward`` in eval mode and every ``predict*`` gather what they return
over the spatial group, so the caller gets what one process returns; in
training ``forward`` returns this rank's blocks (the logits' Y rows, the
depth and seg of its images) and the losses take the matching targets
(``local_targets``).  A pooling index given to it is of this rank's images
(``frame_pooling_index``, ``batch_pooling_indices``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..geometry import get_mlp_input
from ..models.fusion_occ import Batch, FusionOcc, frame_ego_points
from ..ops.bev_pool import PoolingIndex, prepare_pooling_index
from ..utils import profiling
from . import spatial
from .mesh import HybridMesh


class HybridFusionOcc(FusionOcc):
    """FusionOcc on ``mesh``, a ``parallel.mesh.HybridMesh``."""

    def __init__(self, cfg, mesh: HybridMesh, device='cuda'):
        super().__init__(cfg, device)
        self.mesh = mesh

    def frame_pooling_index(self, s2k, intrins, post_rots, post_trans,
                            bda) -> PoolingIndex:
        """``models.fusion_occ.frame_pooling_index`` of this rank's block of
        the B*N images."""
        coor = frame_ego_points(self.cfg, s2k, intrins, post_rots,
                                post_trans, bda)
        return prepare_pooling_index(
            coor, self.cfg.grid,
            self.mesh.image_block(coor.shape[0] * coor.shape[1]))

    def batch_pooling_indices(self, batch: Batch):
        """Per-frame pooling indices of this rank's images of ``batch``."""
        return [self.frame_pooling_index(
                    batch.sensor2keyego[:, f], batch.intrins[:, f],
                    batch.post_rots[:, f], batch.post_trans[:, f], batch.bda)
                for f in range(self.cfg.num_frame)]

    def _frame_voxel_feat(self, imgs_f, s2k_f, s2k_key, intrin_f, post_rot_f,
                          post_tran_f, bda, sparse_depth,
                          pool_idx: Optional[PoolingIndex] = None):
        """The module docstring's first two steps (the random masks keep
        this block of the global batch's draw).  A rank whose block is
        empty (XLA pads it) adds a zero volume to the sum in eval; in
        training it runs the branch on no images, so that it joins the
        collectives of the branch's BatchNorms.  Returns the whole voxel
        feature (B, Z, Y, X, C) and the depth and seg of this rank's
        images, (1, n, h, w, .)."""
        m, cfg = self.mesh, self.cfg
        mlp_input = get_mlp_input(s2k_key, intrin_f, post_rot_f, post_tran_f,
                                  bda)
        B, N = imgs_f.shape[:2]
        a, b = m.image_block(B * N)
        h, w = cfg.feat_size
        D = cfg.grid.num_depth_bins
        if pool_idx is not None and pool_idx.ranks_depth.shape[0] != (
                b - a) * D * h * w:
            raise ValueError(
                f'the pooling index has {pool_idx.ranks_depth.shape[0]} '
                f'points, this rank\'s {b - a} images {(b - a) * D * h * w}:'
                ' build it with the mesh (the model\'s frame_pooling_index)')
        if a == b and not self.training:
            gx, gy, gz = cfg.grid.grid_size
            dev = imgs_f.device
            voxel = torch.zeros(B, gz, gy, gx, cfg.vt.feature_channels,
                                device=dev)
            depth = torch.zeros(1, 0, h, w, D, device=dev)
            seg = torch.zeros(1, 0, h, w, cfg.vt.seg_num_classes,
                              dtype=cfg.dtype, device=dev)
        else:
            mine = self._my_images
            if pool_idx is None:
                with profiling.span('camera.pooling_index'):
                    pool_idx = self.frame_pooling_index(
                        s2k_f, intrin_f, post_rot_f, post_tran_f, bda)
            with m.draws(m.d * B * N + a, m.n_data * B * N):
                x = self.image_encoder(mine(imgs_f))
                with profiling.span('camera.view_transformer'):
                    voxel, depth, seg = self.img_view_transformer(
                        x, mine(sparse_depth), mine(mlp_input), pool_idx,
                        pool_dtype=torch.float32)
        voxel = m.sum_spatial(voxel).to(cfg.dtype)
        with m.replicated(), profiling.span('camera.pre_process'):
            voxel = self.pre_process_net(voxel)[0]
        return voxel, depth, seg

    def _key_images(self, t: torch.Tensor, B: int, F_: int) -> torch.Tensor:
        """This rank's block as it is: ``forward`` gathers the key's."""
        return t

    def _lidar_feat(self, batch: Batch) -> torch.Tensor:
        with self.mesh.replicated():
            return super()._lidar_feat(batch)

    def _head(self, fusion: torch.Tensor) -> torch.Tensor:
        """The logits of this rank's Y rows, from its rows of ``fusion``."""
        return super()._head(self.mesh.y_block(fusion, 2))

    def _trunk(self, fusion: torch.Tensor) -> torch.Tensor:
        feats = spatial.resnet(self.mesh, self.img_bev_encoder_backbone,
                               fusion, self.cfg.grid.grid_size[1],
                               'img_bev_encoder_backbone')
        return spatial.fpn3d(self.mesh, self.img_bev_encoder_neck, feats,
                             'img_bev_encoder_neck')

    def _final_conv(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(spatial.conv(self.mesh, x, self.final_conv.conv,
                                   self.cfg.grid.grid_size[1],
                                   'final_conv.conv')[0])

    def local_targets(self, batch: Batch) -> Batch:
        """The targets of what the training ``forward`` returns: this
        rank's images of ``sparse_depth`` and ``segs`` (1, n, H, W) and its
        Y rows of ``voxel_semantics`` and ``mask_camera``."""
        def rows(t):
            return None if t is None else self.mesh.y_block(t, 2)
        return batch._replace(
            sparse_depth=self._my_images(batch.sparse_depth),
            segs=self._my_images(batch.segs),
            voxel_semantics=rows(batch.voxel_semantics),
            mask_camera=rows(batch.mask_camera))

    def _my_images(self, t: Optional[torch.Tensor]):
        """This rank's block of the B*N images of (B, N, ...) ``t``."""
        if t is None:
            return None
        a, b = self.mesh.image_block(t.shape[0] * t.shape[1])
        return t.reshape((1, -1) + t.shape[2:])[:, a:b]

    # -- the gathers after each entry point --------------------------------
    def _rows(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """Every spatial rank's Y rows (axis ``dim``) of ``t``."""
        return self.mesh.gather(t, dim, self.cfg.grid.grid_size[1])

    def _gathered(self, out: Dict[str, torch.Tensor], B: int, F_: int
                  ) -> Dict[str, torch.Tensor]:
        """``out`` as one process returns it: the logits' Y rows, and the
        key frame's depth and seg (B, N, ...) of a camera pass over B*F_*N
        images, gathered from the ranks' blocks."""
        shape = (B, F_, self.cfg.num_cams)

        def images(t):
            t = self.mesh.gather(t, 1, B * F_ * shape[2])
            return t.reshape(shape + t.shape[2:])[:, 0]
        return {'occ_logits': self._rows(out['occ_logits']),
                'depth': images(out['depth']),
                'seg_logits': images(out['seg_logits'])}

    def forward(self, batch: Batch, pool_idxs=None, **fold):
        out = super().forward(batch, pool_idxs, **fold)
        if self.training:
            return out
        B, F_ = batch.imgs.shape[:2]
        F_ = F_ if fold.get('batch_frames') and self.cfg.num_frame > 1 else 1
        return self._gathered(out, B, F_)

    def predict(self, batch: Batch, pool_idxs=None, **fold):
        return self._rows(super().predict(batch, pool_idxs, **fold))

    def predict_streaming(self, batch: Batch, *args, **kwargs):
        pred, out, state = super().predict_streaming(batch, *args, **kwargs)
        return self._rows(pred), self._gathered(out, len(batch.imgs), 1), state

    def predict_streaming_batch(self, *args, **kwargs):
        preds, state = super().predict_streaming_batch(*args, **kwargs)
        return self._rows(preds, 3), state
