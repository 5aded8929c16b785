"""FusionOcc's training objective.

Port of ``fusionocc_tpu/train/losses.py``:

- depth: binary cross-entropy between the softmaxed depth distribution and
  the one-hot min-pooled LiDAR depth, over pixels with a depth, summed over
  the bins and divided by their count;
- seg: cross-entropy of the 2D semantics at feature resolution, the label
  subsampled with stride ``downsample``, ignoring the free class (17);
- occ: cross-entropy of the occupancy logits, weighted by the camera mask
  and divided by its count (or by the voxel count without it).

total = depth * fuse_w * depth_w + seg * fuse_w + occ.  Every loss is taken
in float32.  Inside a process group each rank divides its own masked sum
by the count of every rank (``global_count``, no gradient), so the ranks'
losses sum to the loss of the global batch, as the JAX package's data mesh
takes it; an average of per-rank ratios would differ wherever the counts
do.  Under the hybrid mesh a rank's depth and seg losses cover its camera
images and its occupancy loss its Y rows
(``parallel.hybrid.HybridFusionOcc.local_targets``): each pixel and voxel
of the global batch on one rank, so the same sum over every rank counts
each once.  JAX takes the occupancy loss in row chunks under ``lax.map``,
a device for its 128-lane padding of the 18 classes; here it is one pass,
the same sums in another order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.lss import downsample_depth_onehot
from ..parallel import mesh

FREE_CLASS = 17


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A loss normaliser over every rank of the process group (this
    rank's outside one), without gradient, at least 1."""
    return mesh.all_reduce_sum(count.detach(), 'loss').clamp_min(1.0)


def depth_loss(depth_pred: torch.Tensor, sparse_depth: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """depth_pred: (B, N, h, w, D) probabilities; sparse_depth (B, N, H, W)
    metres."""
    labels, _ = downsample_depth_onehot(sparse_depth, cfg.vt.downsample,
                                        cfg.grid, sid=cfg.vt.sid)
    labels = labels.reshape(-1, labels.shape[-1])
    pred = depth_pred.float().reshape(-1, depth_pred.shape[-1])
    fg = (labels.amax(dim=1) > 0.0).float()
    p = pred.clamp(1e-7, 1.0 - 1e-7)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return (bce.sum(dim=-1) * fg).sum() / global_count(fg.sum())


def seg_loss(seg_logits: torch.Tensor, segs: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """seg_logits: (B, N, h, w, ncls); segs: (B, N, H, W) int."""
    ds = cfg.vt.downsample
    label = segs[:, :, ::ds, ::ds].reshape(-1).long()
    logits = seg_logits.float().reshape(-1, seg_logits.shape[-1])
    valid = (label != FREE_CLASS).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, label.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]
    return (nll * valid).sum() / global_count(valid.sum())


def occ_loss(logits: torch.Tensor, voxel_semantics: torch.Tensor,
             mask_camera: Optional[torch.Tensor], use_mask: bool
             ) -> torch.Tensor:
    """logits: (B, X, Y, Z, ncls); voxel_semantics and mask_camera
    (B, X, Y, Z)."""
    nc = logits.shape[-1]
    logp = F.log_softmax(logits.reshape(-1, nc).float(), dim=-1)
    label = voxel_semantics.reshape(-1).long()
    nll = -logp.gather(1, label[:, None])[:, 0]
    if use_mask and mask_camera is not None:
        w = mask_camera.reshape(-1).float()
        return (nll * w).sum() / global_count(w.sum())
    return nll.sum() / global_count(nll.new_full((), nll.shape[0]))


def total_loss(outputs: Dict[str, torch.Tensor], batch, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, logs) with the weighted terms ``depth_loss``, ``seg_loss``,
    ``loss_occ`` and their sum ``loss``."""
    d = depth_loss(outputs['depth'], batch.sparse_depth, cfg)
    s = seg_loss(outputs['seg_logits'], batch.segs, cfg)
    o = occ_loss(outputs['occ_logits'], batch.voxel_semantics,
                 batch.mask_camera, cfg.use_mask)
    logs = {'depth_loss': d * cfg.fuse_loss_weight * cfg.depth_loss_weight,
            'seg_loss': s * cfg.fuse_loss_weight,
            'loss_occ': o}
    loss = logs['depth_loss'] + logs['seg_loss'] + logs['loss_occ']
    return loss, {**logs, 'loss': loss}
