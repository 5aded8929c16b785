"""Geometry: the host pose helpers and the LSS view transformer's camera
geometry.

The host half (``quat_to_mat``, ``pose_matrix``, ``sensor2keyego_chain``,
``bda_matrix``) is numpy float64, as in ``fusionocc_tpu/geometry.py``: the
data pipeline builds every pose chain with it.  ``make_frustum``,
``frustum_to_ego``, ``get_mlp_input`` and ``points_to_depthmap`` are float32
tensors with JAX's operation order, so that the frustum coordinates, and
the voxels they quantise to, agree with it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .utils import profiling


# ---------------------------------------------------------------------------
# Host-side (numpy, float64) pose utilities.
# ---------------------------------------------------------------------------

def quat_to_mat(q) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix, float64."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [[1.0 - (yy + zz), xy - wz, xz + wy],
         [xy + wz, 1.0 - (xx + zz), yz - wx],
         [xz - wy, yz + wx, 1.0 - (xx + yy)]], dtype=np.float64)


def pose_matrix(rotation_quat, translation) -> np.ndarray:
    """4x4 homogeneous pose from quaternion + translation (float64)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_mat(rotation_quat)
    m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def sensor2keyego_chain(sensor2egos: np.ndarray,
                        ego2globals: np.ndarray) -> np.ndarray:
    """(F, N, 4, 4) camera->own-ego and ego->global poses -> (F, N, 4, 4)
    float32 camera->key-ego, the key ego being frame 0 / camera 0's; the
    chain is taken in float64."""
    s2e = np.asarray(sensor2egos, dtype=np.float64)
    e2g = np.asarray(ego2globals, dtype=np.float64)
    global2keyego = np.linalg.inv(e2g[0, 0])
    out = global2keyego[None, None] @ e2g @ s2e
    return out.astype(np.float32)


def bda_matrix(rotate_deg: float, scale: float,
               flip_dx: bool, flip_dy: bool) -> np.ndarray:
    """BEV data-augmentation 3x3 matrix (float32): rotation about z, uniform
    scale, then optional x/y flips."""
    a = np.deg2rad(rotate_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                    [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]], dtype=np.float64)
    scale_m = np.eye(3, dtype=np.float64) * scale
    scale_m[2, 2] = scale
    flip = np.eye(3, dtype=np.float64)
    if flip_dx:
        flip[0, 0] = -1.0
    if flip_dy:
        flip[1, 1] = -1.0
    return (flip @ (scale_m @ rot)).astype(np.float32)


# ---------------------------------------------------------------------------
# Tensor geometry.
# ---------------------------------------------------------------------------

def make_frustum(depth_cfg: Tuple[float, float, float],
                 input_size: Tuple[int, int],
                 downsample: int,
                 sid: bool = False,
                 device: torch.device | str = 'cpu') -> torch.Tensor:
    """Frustum template (D, Hf, Wf, 3) of (u, v, d) in input-image pixels.

    Depth bins are an arange over [lo, hi) with the given step (log-spaced
    when ``sid``); pixel centres are linspace(0, size-1, feat).
    """
    h_in, w_in = input_size
    h_feat, w_feat = h_in // downsample, w_in // downsample
    d = np.arange(depth_cfg[0], depth_cfg[1], depth_cfg[2], dtype=np.float32)
    num_d = d.shape[0]
    if sid:
        idx = np.arange(num_d, dtype=np.float32)
        lo, hi, _ = depth_cfg
        d = np.exp(np.log(lo) + idx / (num_d - 1) * np.log((hi - 1.0) / lo))
    d = np.broadcast_to(d[:, None, None], (num_d, h_feat, w_feat))
    x = np.linspace(0, w_in - 1, w_feat, dtype=np.float32)
    x = np.broadcast_to(x[None, None, :], (num_d, h_feat, w_feat))
    y = np.linspace(0, h_in - 1, h_feat, dtype=np.float32)
    y = np.broadcast_to(y[None, :, None], (num_d, h_feat, w_feat))
    frustum = np.stack([x, y, d], axis=-1).astype(np.float32)
    with profiling.wait('frustum.copy'):
        return torch.from_numpy(frustum).to(device)


def frustum_to_ego(frustum: torch.Tensor,
                   sensor2ego: torch.Tensor,
                   intrins: torch.Tensor,
                   post_rots: torch.Tensor,
                   post_trans: torch.Tensor,
                   bda: torch.Tensor) -> torch.Tensor:
    """Map the frustum template into (key-)ego coordinates.

    frustum: (D, Hf, Wf, 3); sensor2ego: (B, N, 4, 4); intrins, post_rots:
    (B, N, 3, 3); post_trans: (B, N, 3); bda: (B, 3, 3).
    Returns (B, N, D, Hf, Wf, 3) float32 ego-frame xyz.
    """
    f32 = torch.float32
    pts = (frustum.to(f32)[None, None]
           - post_trans.to(f32)[:, :, None, None, None, :])
    with profiling.wait('frustum.inverse'):
        inv_post = torch.linalg.inv(post_rots.to(f32))
    pts = torch.einsum('bnij,bndhwj->bndhwi', inv_post, pts)
    # (u*d, v*d, d)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    with profiling.wait('frustum.inverse'):
        inv_intrins = torch.linalg.inv(intrins.to(f32))
    combine = torch.einsum('bnij,bnjk->bnik', sensor2ego[..., :3, :3].to(f32),
                           inv_intrins)
    pts = torch.einsum('bnij,bndhwj->bndhwi', combine, pts)
    pts = pts + sensor2ego[..., :3, 3].to(f32)[:, :, None, None, None, :]
    return torch.einsum('bij,bndhwj->bndhwi', bda.to(f32), pts)


def get_mlp_input(sensor2keyego: torch.Tensor,
                  intrin: torch.Tensor,
                  post_rot: torch.Tensor,
                  post_tran: torch.Tensor,
                  bda: torch.Tensor) -> torch.Tensor:
    """27-dim camera parameter vector per view (B, N, 27).

    The pose argument is the KEY frame's sensor2keyego whichever temporal
    frame is being processed.
    """
    B, N = intrin.shape[:2]
    bda_ = bda[:, None].expand(B, N, 3, 3)
    feats = torch.stack([
        intrin[:, :, 0, 0], intrin[:, :, 1, 1],
        intrin[:, :, 0, 2], intrin[:, :, 1, 2],
        post_rot[:, :, 0, 0], post_rot[:, :, 0, 1], post_tran[:, :, 0],
        post_rot[:, :, 1, 0], post_rot[:, :, 1, 1], post_tran[:, :, 1],
        bda_[:, :, 0, 0], bda_[:, :, 0, 1],
        bda_[:, :, 1, 0], bda_[:, :, 1, 1], bda_[:, :, 2, 2],
    ], dim=-1)
    pose = sensor2keyego[:, :, :3, :].reshape(B, N, 12)
    return torch.cat([feats, pose], dim=-1)


def points_to_depthmap(points_img: torch.Tensor, valid: torch.Tensor,
                       height: int, width: int,
                       depth_range: Tuple[float, float]) -> torch.Tensor:
    """Z-buffered sparse depth map (height, width) float32 from projected
    points: (P, 3) (u, v, depth) in pixels and (P,) bool ``valid``.  Each
    point rounds to its pixel (half to even); the nearest depth in
    [lo, hi) wins; 0 where no point lands."""
    u = torch.round(points_img[:, 0]).long()
    v = torch.round(points_img[:, 1]).long()
    d = points_img[:, 2].float()
    keep = (valid & (u >= 0) & (u < width) & (v >= 0) & (v < height)
            & (d >= depth_range[0]) & (d < depth_range[1]))
    pix = torch.where(keep, v * width + u, height * width)   # dump invalid
    d = torch.where(keep, d, torch.full_like(d, float('inf')))
    flat = torch.full((height * width + 1,), float('inf'),
                      dtype=torch.float32, device=d.device)
    flat = flat.scatter_reduce(0, pix, d, reduce='amin')
    out = flat[:height * width].reshape(height, width)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
