"""Occ3D mIoU: the confusion matrix and the masked mIoU.

Port of ``confusion_matrix``, ``miou_from_hist`` and ``OccupancyMetric`` of
``fusionocc_tpu/eval/metrics.py``, which mirror the reference's Metric_mIoU
(projects/FusionOcc/fusionocc/datasets/occ_metrics.py:44-153): a
(num_classes, num_classes) confusion matrix of (gt, pred) over masked
voxels, per-class IoU = diag / (row + col - diag), and mIoU = the mean over
classes 0..16 of the defined IoUs (the ``free`` class 17 is left out).

The matrix is one ``torch.bincount`` on the predictions' device, in int64
counts; ``OccupancyMetric`` keeps it there, so an update does not wait on
the card.  The radius- and height-bucketed matrices, the F-score, the
calibration and RayIoU are not ported yet (ROADMAP Queue A item 10).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

CLASS_NAMES = ['others', 'barrier', 'bicycle', 'bus', 'car',
               'construction_vehicle', 'motorcycle', 'pedestrian',
               'traffic_cone', 'trailer', 'truck', 'driveable_surface',
               'other_flat', 'sidewalk', 'terrain', 'manmade', 'vegetation',
               'free']


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                     num_classes: int = 18) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts of (gt, pred) over the voxels
    where ``mask`` is set and gt is a class; pred is clipped to the classes."""
    n = num_classes
    pred = pred.reshape(-1).long().clamp(0, n - 1)
    gt = gt.reshape(-1).long().to(pred.device)
    ok = mask.reshape(-1).to(pred.device) & (gt >= 0) & (gt < n)
    key = torch.where(ok, gt * n + pred, n * n)
    return torch.bincount(key, minlength=n * n + 1)[:-1].reshape(n, n)


def miou_from_hist(hist) -> Dict[str, float]:
    """Per-class IoU and masked mIoU in percent, rounded to 2 places (the
    free class is left out of the mean)."""
    hist = np.asarray(hist, np.float64)
    diag = np.diag(hist)
    denom = hist.sum(1) + hist.sum(0) - diag
    with np.errstate(divide='ignore', invalid='ignore'):
        iou = diag / denom
    n = hist.shape[0]
    out = {f'IoU_{CLASS_NAMES[i] if i < len(CLASS_NAMES) else i}':
           float(round(v * 100, 2)) for i, v in enumerate(iou)}
    out['mIoU'] = float(round(np.nanmean(iou[:n - 1]) * 100, 2))
    return out


class OccupancyMetric:
    """Accumulates confusion matrices over batches.  The camera mask, else
    the LiDAR mask, selects the voxels, as the switches ask; without either
    every voxel counts."""

    def __init__(self, num_classes: int = 18, use_image_mask: bool = True,
                 use_lidar_mask: bool = False):
        self.num_classes = num_classes
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.hist = torch.zeros(num_classes, num_classes, dtype=torch.int64)
        self.count = 0

    def update(self, pred: torch.Tensor, gt: torch.Tensor,
               mask_camera: Optional[torch.Tensor] = None,
               mask_lidar: Optional[torch.Tensor] = None) -> None:
        if self.use_image_mask and mask_camera is not None:
            mask = mask_camera
        elif self.use_lidar_mask and mask_lidar is not None:
            mask = mask_lidar
        else:
            mask = torch.ones(gt.shape, dtype=torch.bool, device=gt.device)
        hist = confusion_matrix(pred, gt, mask, self.num_classes)
        self.hist = self.hist.to(hist.device) + hist
        self.count += gt.shape[0] if gt.dim() == 4 else 1

    def compute(self) -> Dict[str, float]:
        return miou_from_hist(self.hist.cpu().numpy())
