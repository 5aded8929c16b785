"""Occ3D mIoU: the confusion matrix, the bucketed matrices, the masked mIoU
and the F-score.

Port of ``fusionocc_tpu/eval/metrics.py``, which mirrors the reference's
Metric_mIoU and Metric_FScore
(projects/FusionOcc/fusionocc/datasets/occ_metrics.py:44-245): a
(num_classes, num_classes) confusion matrix of (gt, pred) over masked
voxels, per-class IoU = diag / (row + col - diag), and mIoU = the mean over
classes 0..16 of the defined IoUs (the ``free`` class 17 is left out).

Each matrix is one ``torch.bincount`` on the predictions' device, in int64
counts (the radius- and height-bucketed ones with the bucket id in the
key); ``OccupancyMetric`` keeps them there, so an update does not wait on
the card.  ``fscore`` is host numpy with ``scipy.spatial.cKDTree``.
Inside a process group ``OccupancyMetric.compute`` sums the matrices over
the ranks (every rank must call it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh

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


def bucketed_confusion_matrix(pred: torch.Tensor, gt: torch.Tensor,
                              mask: torch.Tensor, bucket_id: torch.Tensor,
                              num_buckets: int,
                              num_classes: int = 18) -> torch.Tensor:
    """(num_buckets, C, C) int64 per-bucket confusion matrices in one
    ``bincount``: the voxel's bucket id (clipped to the buckets) joins the
    key."""
    n = num_classes
    pred = pred.reshape(-1).long().clamp(0, n - 1)
    dev = pred.device
    gt = gt.reshape(-1).long().to(dev)
    b = bucket_id.reshape(-1).long().to(dev).clamp(0, num_buckets - 1)
    ok = mask.reshape(-1).to(dev) & (gt >= 0) & (gt < n)
    total = num_buckets * n * n
    key = torch.where(ok, (b * n + gt) * n + pred, total)
    return torch.bincount(key, minlength=total + 1)[:-1].reshape(
        num_buckets, n, n)


def radius_bucket_grid(grid, radius_bins) -> Tuple[np.ndarray, list]:
    """Per-voxel radius-bin id (X, Y, Z) and the bins' labels: the voxel
    centre's planar radius (float32, as JAX takes it), bins half-open, the
    last one open upward."""
    gx, gy, gz = grid.grid_size
    lower = np.float32(grid.lower_bound)
    interval = np.float32(grid.interval)
    xs = lower[0] + (np.arange(gx, dtype=np.float32) + 0.5) * interval[0]
    ys = lower[1] + (np.arange(gy, dtype=np.float32) + 0.5) * interval[1]
    r = np.sqrt(xs[:, None] ** 2 + ys[None, :] ** 2)
    bid = np.clip(np.digitize(r, radius_bins[1:]), 0,
                  len(radius_bins) - 2).astype(np.int32)
    bid = np.broadcast_to(bid[:, :, None], (gx, gy, gz))
    labels = [f'{radius_bins[i]}-{radius_bins[i + 1]}m'
              for i in range(len(radius_bins) - 1)]
    return np.ascontiguousarray(bid), labels


def height_bucket_grid(grid, height_bins_rel) -> Tuple[np.ndarray, list]:
    """Per-voxel height-bin id (X, Y, Z) and labels; the bins are relative
    to the grid floor, the last one open upward."""
    gx, gy, gz = grid.grid_size
    lower = np.float32(grid.lower_bound)
    interval = np.float32(grid.interval)
    zs = lower[2] + (np.arange(gz, dtype=np.float32) + 0.5) * interval[2]
    edges = [lower[2] + np.float32(h) for h in height_bins_rel]
    bid = np.clip(np.digitize(zs, edges[1:]), 0,
                  len(edges) - 2).astype(np.int32)
    bid = np.broadcast_to(bid[None, None, :], (gx, gy, gz))
    labels = [f'{height_bins_rel[i]}-{height_bins_rel[i + 1]}m'
              for i in range(len(height_bins_rel) - 1)]
    return np.ascontiguousarray(bid), labels


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


def fscore(pred: np.ndarray, gt: np.ndarray,
           mask: 'np.ndarray | None' = None,
           voxel_size=(0.4, 0.4, 0.4),
           pc_range=(-40, -40, -1, 40, 40, 5.4),
           free_classes=(17, 255),
           threshold_acc: float = 0.6,
           threshold_complete: float = 0.6) -> dict:
    """Geometric F-score of occupied-voxel surfaces: nearest-neighbour
    distances between the occupied voxel centres of prediction and GT,
    thresholded into accuracy (pred to gt) and completeness (gt to pred),
    combined harmonically.  Exact nearest neighbours by ``cKDTree``."""
    from scipy.spatial import cKDTree
    pred = np.array(pred)
    gt = np.array(gt)
    if mask is not None:
        pred = np.where(mask, pred, 255)
        gt = np.where(mask, gt, 255)

    def to_points(vox):
        occ = ~np.isin(vox, list(free_classes))
        idx = np.stack(np.nonzero(occ), axis=1).astype(np.float64)
        return (idx + 0.5) * np.asarray(voxel_size) + np.asarray(pc_range[:3])

    p, g = to_points(pred), to_points(gt)
    if len(p) == 0 or len(g) == 0:
        return {'accuracy': 0.0, 'completeness': 0.0, 'fscore': 0.0}
    complete_d, _ = cKDTree(p, leafsize=10).query(g)
    acc_d, _ = cKDTree(g, leafsize=10).query(p)
    completeness = float((complete_d.ravel() < threshold_complete).mean())
    accuracy = float((acc_d.ravel() < threshold_acc).mean())
    eps = 1e-8
    f = 2.0 / (1 / (accuracy + eps) + 1 / (completeness + eps))
    return {'accuracy': accuracy, 'completeness': completeness, 'fscore': f}


class OccupancyMetric:
    """Accumulates confusion matrices over batches.  The camera mask, else
    the LiDAR mask, selects the voxels, as the switches ask; without either
    every voxel counts.  With ``grid`` it also accumulates radius- and
    height-bucketed matrices (the reference evaluator's distance- and
    height-conditioned mIoU).  With a ``parallel.mesh.HybridMesh`` each
    update takes this rank's Y rows of the full (X, Y, Z) maps it is given
    (what a spatial rank predicts), so the matrices summed over every rank
    count each voxel once."""

    RADIUS_BINS = (0, 20, 25, 30, 35, 40, 45, 50)
    HEIGHT_BINS_REL = (0, 2, 4, 6)

    def __init__(self, num_classes: int = 18, use_image_mask: bool = True,
                 use_lidar_mask: bool = False, grid=None, mesh=None):
        self.mesh = mesh
        self.num_classes = num_classes
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.hist = torch.zeros(num_classes, num_classes, dtype=torch.int64)
        self.count = 0
        self.buckets = {}
        if grid is not None:
            for name, (bid, labels) in (
                    ('radius', radius_bucket_grid(grid, self.RADIUS_BINS)),
                    ('height', height_bucket_grid(grid,
                                                  self.HEIGHT_BINS_REL))):
                self.buckets[name] = {
                    'id': torch.from_numpy(bid), 'labels': labels,
                    'hist': torch.zeros(len(labels), num_classes,
                                        num_classes, dtype=torch.int64)}

    def update(self, pred: torch.Tensor, gt: torch.Tensor,
               mask_camera: Optional[torch.Tensor] = None,
               mask_lidar: Optional[torch.Tensor] = None) -> None:
        if self.mesh is not None:       # this rank's Y rows (axis -2)
            def rows(t):
                return None if t is None else self.mesh.y_block(
                    t, t.dim() - 2)
            pred, gt, mask_camera, mask_lidar = map(
                rows, (pred, gt, mask_camera, mask_lidar))
        if self.use_image_mask and mask_camera is not None:
            mask = mask_camera
        elif self.use_lidar_mask and mask_lidar is not None:
            mask = mask_lidar
        else:
            mask = torch.ones(gt.shape, dtype=torch.bool, device=gt.device)
        hist = confusion_matrix(pred, gt, mask, self.num_classes)
        self.hist = self.hist.to(hist.device) + hist
        for b in self.buckets.values():
            bid = b['id'] = b['id'].to(hist.device)
            if self.mesh is not None:
                bid = self.mesh.y_block(bid, 1)
            if gt.dim() == 4:                       # (B, X, Y, Z)
                bid = bid[None].expand(gt.shape)
            b['hist'] = b['hist'].to(hist.device) + bucketed_confusion_matrix(
                pred, gt, mask, bid, len(b['labels']), self.num_classes)
        self.count += gt.shape[0] if gt.dim() == 4 else 1

    @staticmethod
    def reduced_hist(hist: torch.Tensor) -> np.ndarray:
        """The matrix summed over the ranks of the process group (this
        process's outside one), as numpy.  JAX gathers the hosts' matrices
        and sums them; a sum all-reduce gives the same integers (NCCL
        reduces on the card: a matrix that no update moved there goes to
        this rank's card first)."""
        if (mesh.data_mesh() is not None and not hist.is_cuda
                and torch.distributed.get_backend() == 'nccl'):
            hist = hist.cuda()
        return mesh.all_reduce_sum(hist, 'metric').cpu().numpy()

    def compute(self) -> Dict[str, float]:
        out = miou_from_hist(self.reduced_hist(self.hist))
        for name, b in self.buckets.items():
            hist = self.reduced_hist(b['hist'])
            for i, label in enumerate(b['labels']):
                out[f'mIoU_{name}_{label}'] = miou_from_hist(hist[i])['mIoU']
        return out
