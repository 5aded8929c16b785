"""Host-side data pipeline (numpy and PIL), the port's copy of
``fusionocc_tpu/data/pipeline.py``.

Each function is the same pure transform as JAX's, in the same operation
order, so a sample the port's dataset builds equals JAX's.  ``stack_batch``
assembles the port's ``Batch`` as CPU tensors (pinned when the batch is
bound for the card) and ``to_device`` moves it, one ``non_blocking`` copy
per field; the evaluation and training loops call it, not the dataset.

Quirks kept from the reference, as JAX keeps them:
  - image normalisation swaps R and B (the reference feeds PIL RGB arrays
    to mmcv ``imnormalize(to_rgb=True)``, which assumes BGR);
  - the pose chain is taken in float64;
  - sweep subsampling keeps ring index > 16 or a random 20 %;
  - the range filter shrinks the box by eps = 1e-3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..geometry import bda_matrix
from ..models.fusion_occ import Batch

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclasses.dataclass
class ImageAug:
    """One camera's sampled augmentation (loading.py:139-167)."""
    resize: float
    resize_dims: Tuple[int, int]   # (W, H) for PIL
    crop: Tuple[int, int, int, int]
    flip: bool
    rotate: float                  # degrees


def sample_image_aug(src_hw: Tuple[int, int], input_hw: Tuple[int, int],
                     train: bool, rng: np.random.RandomState,
                     resize_range=(-0.06, 0.11), rot_range=(-5.4, 5.4),
                     crop_h=(0.0, 0.0), allow_flip=True,
                     resize_test: float = 0.0) -> ImageAug:
    H, W = src_hw
    fH, fW = input_hw
    base = float(fW) / float(W)
    if train:
        resize = base + rng.uniform(*resize_range)
        newW, newH = int(W * resize), int(H * resize)
        ch = int((1 - rng.uniform(*crop_h)) * newH) - fH
        cw = int(rng.uniform(0, max(0, newW - fW)))
        crop = (cw, ch, cw + fW, ch + fH)
        flip = bool(allow_flip and rng.choice([0, 1]))
        rotate = float(rng.uniform(*rot_range))
    else:
        resize = base + resize_test
        newW, newH = int(W * resize), int(H * resize)
        ch = int((1 - np.mean(crop_h)) * newH) - fH
        cw = int(max(0, newW - fW) / 2)
        crop = (cw, ch, cw + fW, ch + fH)
        flip, rotate = False, 0.0
    return ImageAug(resize, (newW, newH), crop, flip, rotate)


def _rot2d(deg: float) -> np.ndarray:
    h = np.deg2rad(deg)
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]],
                    np.float64)


def aug_homography(aug: ImageAug) -> Tuple[np.ndarray, np.ndarray]:
    """(post_rot 3x3, post_tran 3) tracking the pixel-coordinate effect of
    resize/crop/flip/rotate (loading.py:76-93 img_transform)."""
    post_rot = np.eye(2, dtype=np.float64) * aug.resize
    post_tran = -np.asarray(aug.crop[:2], np.float64) * 1.0
    post_tran = post_rot @ np.zeros(2) + post_tran  # crop after resize
    # note: reference does post_rot *= resize; post_tran -= crop[:2]
    if aug.flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([aug.crop[2] - aug.crop[0], 0.0])
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = _rot2d(aug.rotate)
    b = np.array([aug.crop[2] - aug.crop[0], aug.crop[3] - aug.crop[1]]) / 2.0
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    pr = np.eye(3, dtype=np.float32)
    pr[:2, :2] = post_rot
    pt = np.zeros(3, np.float32)
    pt[:2] = post_tran
    return pr, pt


def transform_image(img, aug: ImageAug, nearest: bool = False):
    """Resize, crop, flip and rotate with PIL's resamplers, as the reference
    does (BILINEAR, or NEAREST for label maps)."""
    from PIL import Image
    if not isinstance(img, Image.Image):
        img = Image.fromarray(img)
    img = img.resize(aug.resize_dims,
                     Image.NEAREST if nearest else Image.BILINEAR)
    img = img.crop(aug.crop)
    if aug.flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    if aug.rotate != 0.0:   # rotate(0) is still a full resample pass
        img = img.rotate(aug.rotate, resample=Image.NEAREST if nearest else
                         Image.BILINEAR)
    return img


_IMAGENET_INV_STD = np.float32(1.0) / np.asarray(IMAGENET_STD, np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """ImageNet normalization WITH the reference's R<->B swap.

    Single allocation + two in-place passes (this runs 12x per sample on
    the host loader's critical path)."""
    out = np.asarray(img).astype(np.float32)[..., ::-1]
    out -= IMAGENET_MEAN
    out *= _IMAGENET_INV_STD
    return out


# ---------------------------------------------------------------------------
# LiDAR transforms
# ---------------------------------------------------------------------------

def load_points_bin(path: str, load_dim: int = 5) -> np.ndarray:
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, load_dim)


def fuse_adjacent_sweeps(curr_points: np.ndarray,
                         curr_l2e: np.ndarray, curr_e2g: np.ndarray,
                         sweeps: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                         rng: np.random.RandomState,
                         subsample: bool = True) -> np.ndarray:
    """Transform previous key-frame clouds into the current lidar frame and
    concatenate (loading.py:782-839).

    sweeps: list of (points, lidar2ego, ego2global) for previous frames.
    Subsampling keeps points with ring index > 16 OR a random 20%.
    """
    curr_T = (curr_e2g @ curr_l2e).astype(np.float64)
    inv_curr = np.linalg.inv(curr_T)
    clouds = [curr_points]
    for pts, l2e, e2g in sweeps:
        T = inv_curr @ (e2g.astype(np.float64) @ l2e.astype(np.float64))
        xyz = pts[:, :3].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        out = pts.copy()
        out[:, :3] = xyz.astype(np.float32)
        clouds.append(out)
    fused = np.concatenate(clouds, axis=0)
    if subsample:
        keep = (fused[:, 4] > 16) | (rng.rand(len(fused)) < 0.2)
        fused = fused[keep]
    return fused


def points_lidar_to_ego(points: np.ndarray, l2e: np.ndarray) -> np.ndarray:
    out = points.copy()
    out[:, :3] = (points[:, :3].astype(np.float64) @ l2e[:3, :3].T
                  + l2e[:3, 3]).astype(np.float32)
    return out


def filter_points_range(points: np.ndarray, pcr: Sequence[float],
                        eps: float = 1e-3) -> np.ndarray:
    """Crop to the (slightly shrunk) point-cloud range (loading.py:1087-1139)."""
    lo = np.asarray(pcr[:3]) + eps
    hi = np.asarray(pcr[3:]) - eps
    m = np.all((points[:, :3] >= lo) & (points[:, :3] <= hi), axis=1)
    return points[m]


def apply_bda_to_points(points: np.ndarray, bda: np.ndarray) -> np.ndarray:
    out = points.copy()
    out[:, :3] = points[:, :3] @ bda.T
    return out


def apply_bda_to_voxels(voxel_semantics: np.ndarray, masks: List[np.ndarray],
                        flip_dx: bool, flip_dy: bool):
    """Flip the voxel GT consistently with the BDA flips (loading.py:897-957)."""
    vs = voxel_semantics
    ms = list(masks)
    if flip_dx:
        vs = vs[::-1]
        ms = [m[::-1] for m in ms]
    if flip_dy:
        vs = vs[:, ::-1]
        ms = [m[:, ::-1] for m in ms]
    return np.ascontiguousarray(vs), [np.ascontiguousarray(m) for m in ms]


def sample_bda(rng: np.random.RandomState, train: bool,
               rot_lim=(0.0, 0.0), scale_lim=(1.0, 1.0),
               flip_dx_ratio=0.5, flip_dy_ratio=0.5):
    """(bda 3x3, rotate, scale, flip_dx, flip_dy) — configs/fusion_occ.py:147-151."""
    if train:
        rot = float(rng.uniform(*rot_lim))
        scale = float(rng.uniform(*scale_lim))
        flip_dx = bool(rng.rand() < flip_dx_ratio)
        flip_dy = bool(rng.rand() < flip_dy_ratio)
    else:
        rot, scale, flip_dx, flip_dy = 0.0, 1.0, False, False
    return bda_matrix(rot, scale, flip_dx, flip_dy), rot, scale, flip_dx, flip_dy


# ---------------------------------------------------------------------------
# Point -> per-camera sparse depth (z-buffer)
# ---------------------------------------------------------------------------

def points_to_depthmap_np(points_img: np.ndarray, height: int, width: int,
                          depth_range: Tuple[float, float]) -> np.ndarray:
    """Numpy z-buffer matching depth_transforms.py:26-60 exactly
    (round to pixel, min depth wins via (rank + d/100) argsort dedup)."""
    coor = np.round(points_img[:, :2])
    depth = points_img[:, 2]
    kept = ((coor[:, 0] >= 0) & (coor[:, 0] < width) &
            (coor[:, 1] >= 0) & (coor[:, 1] < height) &
            (depth < depth_range[1]) & (depth >= depth_range[0]))
    coor, depth = coor[kept], depth[kept]
    ranks = coor[:, 0] + coor[:, 1] * width
    order = np.argsort(ranks + depth / 100.0, kind='stable')
    coor, depth, ranks = coor[order], depth[order], ranks[order]
    keep_first = np.ones(len(coor), bool)
    keep_first[1:] = ranks[1:] != ranks[:-1]
    coor, depth = coor[keep_first].astype(np.int64), depth[keep_first]
    out = np.zeros((height, width), np.float32)
    out[coor[:, 1], coor[:, 0]] = depth
    return out


def project_points_to_cam(points_ego_or_lidar: np.ndarray,
                          lidar2cam: np.ndarray, intrin: np.ndarray,
                          post_rot: np.ndarray, post_tran: np.ndarray
                          ) -> np.ndarray:
    """(P, 3) of (u, v, depth) after intrinsics + the augmentation homography
    (lidar2img = cam2img @ lidar2cam, depth_transforms.py:164-196)."""
    cam = points_ego_or_lidar[:, :3] @ lidar2cam[:3, :3].T + lidar2cam[:3, 3]
    img = cam @ np.asarray(intrin, cam.dtype).T
    uv = img[:, :2] / np.maximum(img[:, 2:3], 1e-6)
    uvd = np.concatenate([uv, cam[:, 2:3]], axis=1)
    return uvd @ post_rot.T + post_tran[None, :]


# ---------------------------------------------------------------------------
# Batch assembly
# ---------------------------------------------------------------------------

def pad_points(points: np.ndarray, capacity: int,
               rng: np.random.RandomState | None = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/limit a point cloud to the static capacity.

    Overflow is UNIFORMLY SUBSAMPLED, not tail-truncated: points arrive
    ordered by sweep (fuse_adjacent_sweeps), so dropping the tail would
    discard whole late sweeps on dense scenes.  rng=None keeps a
    deterministic every-k-th subsample (eval)."""
    P = len(points)
    if P > capacity:
        if rng is not None:
            keep = rng.choice(P, capacity, replace=False)
            keep.sort()
        else:
            keep = np.linspace(0, P - 1, capacity).astype(np.int64)
        out = points[keep]
        mask = np.ones(capacity, bool)
    elif P == capacity:
        out = points
        mask = np.ones(capacity, bool)
    else:
        out = np.concatenate(
            [points, np.zeros((capacity - P, points.shape[1]),
                              points.dtype)], axis=0)
        mask = np.arange(capacity) < P
    return out.astype(np.float32), mask


def stack_batch(samples: List[Dict], pin_memory: bool = False) -> Batch:
    """Stack per-sample dicts (keys = Batch fields) into a Batch of CPU
    tensors, in pinned memory with ``pin_memory`` (a batch bound for the
    card).  A field that the first sample lacks is None."""
    def get(k):
        vals = [s.get(k) for s in samples]
        if vals[0] is None:
            return None
        t = torch.from_numpy(np.stack(vals, axis=0))
        return t.pin_memory() if pin_memory else t
    return Batch(**{k: get(k) for k in Batch._fields})


def to_device(batch: Batch, device) -> Batch:
    """``batch`` on ``device``: one ``non_blocking`` copy per field (from
    pinned memory the copies overlap the card's work)."""
    return Batch(*(None if a is None else a.to(device, non_blocking=True)
                   for a in batch))
