"""Synthetic batch generator with realistic geometry.

The same numpy draws, in the same order and from the same seed, as
``fusionocc_tpu/data/synthetic.py``, so both packages see identical inputs;
the arrays are handed over as tensors on the requested device, the card
unless the caller asks for the CPU.  The LiDAR cloud is drawn even when the
model is image-only, because the sparse depth is drawn after it from the
same ``RandomState``.  Over R processes each rank takes its rows of the
global batch of the seed (``parallel.mesh.shard_batch`` of
``synthetic_batch(cfg, R * b, seed)``), as the JAX package shards it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..models.fusion_occ import Batch


def _camera_rig(num_cams: int) -> np.ndarray:
    """(N, 4, 4) sensor2ego poses: cameras on a ring looking outward."""
    poses = []
    for i in range(num_cams):
        yaw = 2 * np.pi * i / num_cams
        # camera frame: +z forward (optical), +x right, +y down
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, -down, fwd], axis=1)  # columns: x_cam,y_cam,z_cam
        t = fwd * 1.0 + np.array([0.0, 0.0, 1.5])
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = t
        poses.append(m)
    return np.stack(poses).astype(np.float32)


def beam_lidar_cloud(rng: np.random.RandomState, capacity: int,
                     pcr, num_sweeps: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Simulated multi-sweep spinning-LiDAR cloud (ego frame), 5-dim points.

    A 32-beam rig (elevations -30.7..10.7 deg) at 1.84 m, ray-cast against a
    ground plane and axis-aligned boxes (cars, walls) over ``num_sweeps``
    sweeps with the ego moving 2.5 m per sweep, then the reference's sweep
    subsampling (ring > 16, else 20%).  Returns (points (capacity, 5)
    float32, mask (capacity,) bool).
    """
    n_beams, n_az = 32, 1100
    elev = np.deg2rad(np.linspace(-30.67, 10.67, n_beams))
    boxes = []   # (min_xyz, max_xyz)
    for _ in range(22):   # cars
        cx, cy = rng.uniform(-32, 32, 2)
        L, W, H = 4.5, 2.0, rng.uniform(1.4, 2.0)
        if rng.rand() < 0.5:
            L, W = W, L
        boxes.append(([cx - L / 2, cy - W / 2, 0.0],
                      [cx + L / 2, cy + W / 2, H]))
    for _ in range(10):   # building walls
        cx, cy = rng.uniform(-38, 38, 2)
        if abs(cx) < 12 and abs(cy) < 12:
            cx += np.sign(cx or 1) * 15
        L = rng.uniform(8, 25)
        W = rng.uniform(0.5, 3.0)
        if rng.rand() < 0.5:
            L, W = W, L
        boxes.append(([cx - L / 2, cy - W / 2, 0.0],
                      [cx + L / 2, cy + W / 2, rng.uniform(4, 10)]))
    bmin = np.asarray([b[0] for b in boxes], np.float32)  # (K, 3)
    bmax = np.asarray([b[1] for b in boxes], np.float32)

    az = (np.arange(n_az)[None] + rng.rand(num_sweeps, 1)).astype(np.float32)
    az = az.reshape(num_sweeps, n_az, 1) * (2 * np.pi / n_az)
    ce, se = np.cos(elev).astype(np.float32), np.sin(elev).astype(np.float32)
    d = np.stack([np.cos(az) * ce, np.sin(az) * ce,
                  np.broadcast_to(se, (num_sweeps, n_az, n_beams))],
                 -1).reshape(-1, 3)                             # (R, 3)
    ring = np.broadcast_to(np.arange(n_beams), (num_sweeps, n_az, n_beams)
                           ).reshape(-1)
    origin = np.zeros((num_sweeps, 1, 1, 3), np.float32)
    origin[..., 0] = -2.5 * np.arange(num_sweeps).reshape(-1, 1, 1)
    origin[..., 2] = 1.84
    o = np.broadcast_to(origin, (num_sweeps, n_az, n_beams, 3)).reshape(-1, 3)
    # ground plane z=0
    with np.errstate(divide='ignore', invalid='ignore'):
        t_g = np.where(d[:, 2] < -1e-6, -o[:, 2] / d[:, 2], np.inf)
    # AABB slab test, rays x boxes, chunked to stay cache-resident
    t = np.empty(len(d), np.float32)
    for i in range(0, len(d), 16384):
        dd, oo = d[i:i + 16384], o[i:i + 16384]
        inv = 1.0 / np.where(np.abs(dd) > 1e-9, dd, 1e-9)
        t0 = (bmin[None] - oo[:, None]) * inv[:, None]          # (r, K, 3)
        t1 = (bmax[None] - oo[:, None]) * inv[:, None]
        tn = np.minimum(t0, t1).max(-1)
        tf = np.maximum(t0, t1).min(-1)
        hit = (tn < tf) & (tn > 0.1)
        t_b = np.where(hit, tn, np.inf).min(-1)                 # (r,)
        t[i:i + 16384] = np.minimum(t_g[i:i + 16384], t_b)
    ok = np.isfinite(t) & (t < 70.0) & (rng.rand(len(t)) > 0.03)
    pts = o[ok] + d[ok] * t[ok, None]
    pts += rng.randn(*pts.shape).astype(np.float32) * 0.012     # range noise
    pts = pts.astype(np.float32)
    ring = ring[ok]
    keep = (ring > 16) | (rng.rand(len(ring)) < 0.2)
    pts, ring = pts[keep], ring[keep]
    inside = ((pts[:, 0] > pcr[0]) & (pts[:, 0] < pcr[3]) &
              (pts[:, 1] > pcr[1]) & (pts[:, 1] < pcr[4]) &
              (pts[:, 2] > pcr[2]) & (pts[:, 2] < pcr[5]))
    pts, ring = pts[inside], ring[inside]
    n = min(len(pts), capacity)
    sel = rng.permutation(len(pts))[:n]
    out = np.zeros((capacity, 5), np.float32)
    out[:n, :3] = pts[sel]
    out[:n, 3] = rng.rand(n)            # intensity
    out[:n, 4] = ring[sel]
    mask = np.zeros((capacity,), bool)
    mask[:n] = True
    return out, mask


def synthetic_batch(cfg: ModelConfig, batch_size: int = 1, seed: int = 0,
                    num_points: int | None = None,
                    device: torch.device | str = 'cuda',
                    frames: int | None = None) -> Batch:
    """A synthetic ``Batch`` of tensors on ``device``, of ``frames``
    temporal frames (``cfg.num_frame`` by default; a model's
    ``input_frames``)."""
    rng = np.random.RandomState(seed)
    B, F, N = batch_size, frames or cfg.num_frame, cfg.num_cams
    H, W = cfg.input_size
    gx, gy, gz = cfg.grid.grid_size

    # [0,1) noise images; PCG64 emits float32 natively
    frng = np.random.default_rng(seed)
    imgs = frng.random((B, F, N, H, W, 3), dtype=np.float32)

    rig = _camera_rig(N)
    s2k = np.tile(rig[None, None], (B, F, 1, 1, 1)).astype(np.float32)
    # adjacent frames: ego moved ~0.5 m backwards between frames
    for f in range(1, F):
        shift = np.eye(4, dtype=np.float32)
        shift[0, 3] = -0.5 * f
        s2k[:, f] = np.einsum('ij,bnjk->bnik', shift, s2k[:, f])

    fx = 0.6 * W
    intr = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    intrins = np.tile(intr[None, None, None], (B, F, N, 1, 1))
    post_rots = np.tile(np.eye(3, dtype=np.float32)[None, None, None],
                        (B, F, N, 1, 1))
    post_trans = np.zeros((B, F, N, 3), np.float32)
    bda = np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1))

    P = num_points or cfg.lidar.point_capacity
    pcr = cfg.grid.point_cloud_range
    pts = np.zeros((B, P, 5), np.float32)
    points_mask = np.zeros((B, P), bool)
    for b in range(B):
        pts[b], points_mask[b] = beam_lidar_cloud(rng, P, pcr)

    # sparse depth: ~2% of pixels carry a depth in the valid range
    lo, hi, _ = cfg.grid.depth
    sd = rng.uniform(lo, hi - 1e-3, (B, N, H, W)).astype(np.float32)
    sd = np.where(rng.rand(B, N, H, W) < 0.02, sd, 0.0).astype(np.float32)

    segs = rng.randint(0, cfg.num_classes, (B, N, H, W)).astype(np.int32)
    voxel_semantics = rng.randint(0, cfg.num_classes,
                                  (B, gx, gy, gz)).astype(np.int32)
    mask_camera = rng.rand(B, gx, gy, gz) > 0.3

    ego2global = np.tile(np.eye(4, dtype=np.float32)[None], (B, 1, 1))
    ego2global[:, 0, 3] = seed * 0.5  # distinct poses across seeds

    arrays = dict(
        imgs=imgs, sensor2keyego=s2k, intrins=intrins, post_rots=post_rots,
        post_trans=post_trans, bda=bda, points=pts, points_mask=points_mask,
        sparse_depth=sd, segs=segs, voxel_semantics=voxel_semantics,
        mask_camera=mask_camera, ego2global=ego2global)
    return Batch(**{k: torch.from_numpy(v).to(device)
                    for k, v in arrays.items()})
