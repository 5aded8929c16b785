"""The benchmark's inputs, made on the device from the run's seed.

Everything is drawn from ``torch.Generator``s on the device, one per kind of
input (``generator(seed, stream)``), in a few large calls, so the same seed
gives the same inputs on the same device.  A scene is ``frames`` key frames
of one drive at 2 Hz: the ego moves forward at a speed and yaw rate drawn
per scene, six cameras on a ring look outward (the rig of the repository's
synthetic data), every frame has its own images (uniform noise in [0, 1)),
its own LiDAR sweep (``beam_cloud``: the beam model of the repository's
synthetic generator, ray-cast on the device) and its own sparse depth (2 %
of the pixels).  Nothing here comes from the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

STREAMS = {'weights': 0, 'scene': 1, 'images': 2, 'lidar': 3, 'depth': 4,
           'labels': 5, 'sample': 6}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of one kind of input of a run."""
    key = (int(seed) * len(STREAMS) + STREAMS[stream]) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(key)


def camera_rig(num_cams: int, device) -> torch.Tensor:
    """(N, 4, 4) sensor2ego: cameras 1 m out on a ring at 1.5 m height,
    +z optical axis outward, +x right, +y down."""
    yaw = 2 * math.pi * torch.arange(num_cams, dtype=torch.float64) / num_cams
    fwd = torch.stack([yaw.cos(), yaw.sin(), torch.zeros_like(yaw)], -1)
    right = torch.stack([-yaw.sin(), yaw.cos(), torch.zeros_like(yaw)], -1)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64).expand(
        num_cams, 3)
    m = torch.eye(4, dtype=torch.float64).repeat(num_cams, 1, 1)
    m[:, :3, :3] = torch.stack([right, -down, fwd], -1)
    m[:, :3, 3] = fwd + torch.tensor([0.0, 0.0, 1.5], dtype=torch.float64)
    return m.float().to(device)


def intrinsics(input_size, device) -> torch.Tensor:
    H, W = input_size
    fx = 0.6 * W
    return torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def ego_path(frames: int, g: torch.Generator, device) -> torch.Tensor:
    """(frames, 4, 4) ego2global of a drive at 2 Hz: speed U(4, 12) m/s,
    yaw rate U(-0.15, 0.15) rad per frame, from a random start."""
    u = torch.rand(5, generator=g, device=device, dtype=torch.float64)
    speed, rate = 4.0 + 8.0 * u[0], 0.3 * (u[1] - 0.5)
    yaw0 = 2 * math.pi * u[2]
    t = torch.arange(frames, device=device, dtype=torch.float64)
    yaw = yaw0 + rate * t
    step = 0.5 * speed
    x = 100.0 * u[3] + torch.cumsum(step * yaw.cos(), 0) - step * yaw[0].cos()
    y = 100.0 * u[4] + torch.cumsum(step * yaw.sin(), 0) - step * yaw[0].sin()
    m = torch.eye(4, dtype=torch.float64, device=device).repeat(frames, 1, 1)
    m[:, 0, 0], m[:, 0, 1] = yaw.cos(), -yaw.sin()
    m[:, 1, 0], m[:, 1, 1] = yaw.sin(), yaw.cos()
    m[:, 0, 3], m[:, 1, 3] = x, y
    return m.float()


def beam_cloud(g: torch.Generator, capacity: int, pcr, device,
               num_sweeps: int = 8):
    """A multi-sweep spinning-LiDAR cloud in the ego frame, (capacity, 5)
    float32 (x, y, z, intensity, ring) and its (capacity,) bool mask.

    A 32-beam rig (elevations -30.67..10.67 deg) at 1.84 m ray-cast against
    the ground and 22 car-sized and 10 wall-sized boxes over ``num_sweeps``
    sweeps, the ego 2.5 m further back each sweep; 3 % of returns dropped,
    1.2 cm range noise, rings up to 16 kept at 20 %, clipped to the point
    cloud range and shuffled."""
    f32 = dict(dtype=torch.float32, device=device)
    n_beams, n_az = 32, 1100
    u = torch.rand(22 * 4 + 10 * 6, generator=g, **f32)
    car, wall = u[:88].view(22, 4), u[88:].view(10, 6)
    c_xy = -32 + 64 * car[:, :2]
    flip = car[:, 3] < 0.5
    L = torch.where(flip, 2.0, 4.5)
    W = torch.where(flip, 4.5, 2.0)
    c_h = 1.4 + 0.6 * car[:, 2]
    w_xy = -38 + 76 * wall[:, :2]
    near = (w_xy.abs() < 12).all(1, keepdim=True)
    w_xy = torch.where(near, w_xy + 15 * torch.where(w_xy >= 0, 1.0, -1.0),
                       w_xy)
    wl, ww = 8 + 17 * wall[:, 2], 0.5 + 2.5 * wall[:, 3]
    wflip = wall[:, 4] < 0.5
    WL, WW = torch.where(wflip, ww, wl), torch.where(wflip, wl, ww)
    w_h = 4 + 6 * wall[:, 5]
    half = torch.cat([torch.stack([L, W], 1), torch.stack([WL, WW], 1)]) / 2
    ctr = torch.cat([c_xy, w_xy])
    top = torch.cat([c_h, w_h])
    bmin = torch.cat([ctr - half, torch.zeros_like(top)[:, None]], 1)
    bmax = torch.cat([ctr + half, top[:, None]], 1)

    elev = torch.deg2rad(torch.linspace(-30.67, 10.67, n_beams, **f32))
    az = (torch.arange(n_az, **f32)[None]
          + torch.rand(num_sweeps, 1, generator=g, **f32))
    az = (az * (2 * math.pi / n_az))[:, :, None].expand(num_sweeps, n_az,
                                                        n_beams)
    d = torch.stack([az.cos() * elev.cos(), az.sin() * elev.cos(),
                     elev.sin().expand_as(az)], -1).reshape(-1, 3)
    ring = torch.arange(n_beams, device=device).repeat(num_sweeps * n_az)
    o = torch.zeros(num_sweeps, 3, **f32)
    o[:, 0] = -2.5 * torch.arange(num_sweeps, **f32)
    o[:, 2] = 1.84
    o = o.repeat_interleave(n_az * n_beams, 0)
    t_g = torch.where(d[:, 2] < -1e-6, -o[:, 2] / d[:, 2],
                      torch.full_like(d[:, 2], float('inf')))
    inv = 1.0 / torch.where(d.abs() > 1e-9, d, torch.full_like(d, 1e-9))
    t0 = (bmin[None] - o[:, None]) * inv[:, None]
    t1 = (bmax[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    hit = (tn < tf) & (tn > 0.1)
    t_b = torch.where(hit, tn, torch.full_like(tn, float('inf'))).amin(-1)
    t = torch.minimum(t_g, t_b)
    ok = (torch.isfinite(t) & (t < 70.0)
          & (torch.rand(t.shape, generator=g, **f32) > 0.03))
    pts = o + d * torch.where(ok, t, 0.0)[:, None]
    pts = pts + torch.randn(pts.shape, generator=g, **f32) * 0.012
    keep = ok & ((ring > 16)
                 | (torch.rand(ring.shape, generator=g, **f32) < 0.2))
    inside = keep & ((pts[:, 0] > pcr[0]) & (pts[:, 0] < pcr[3])
                     & (pts[:, 1] > pcr[1]) & (pts[:, 1] < pcr[4])
                     & (pts[:, 2] > pcr[2]) & (pts[:, 2] < pcr[5]))
    order = torch.argsort(torch.rand(t.shape, generator=g, **f32)
                          + (~inside).float())
    n = min(int(inside.sum()), capacity)
    sel = order[:n]
    out = torch.zeros(capacity, 5, **f32)
    out[:n, :3] = pts[sel]
    out[:n, 3] = torch.rand(n, generator=g, **f32)
    out[:n, 4] = ring[sel].float()
    mask = torch.zeros(capacity, dtype=torch.bool, device=device)
    mask[:n] = True
    return out, mask


def make_scene(cfg, frames: int, seed: int, device, labels: bool = False
               ) -> Dict[str, torch.Tensor]:
    """``frames`` key frames of one drive, stacked on a leading axis:
    imgs (T, N, H, W, 3), ego2global (T, 4, 4), points (T, P, 5),
    points_mask (T, P), sparse_depth (T, N, H, W); with ``labels`` also
    segs (T, N, H, W), voxel_semantics (T, X, Y, Z) and mask_camera."""
    N = cfg.num_cams
    H, W = cfg.input_size
    f32 = dict(dtype=torch.float32, device=device)
    out = {'ego2global': ego_path(frames, generator(seed, 'scene', device),
                                  device)}
    out['imgs'] = torch.rand((frames, N, H, W, 3),
                             generator=generator(seed, 'images', device),
                             **f32)
    gl = generator(seed, 'lidar', device)
    P = cfg.lidar.point_capacity
    clouds = [beam_cloud(gl, P, cfg.grid.point_cloud_range, device)
              for _ in range(frames)]
    out['points'] = torch.stack([c[0] for c in clouds])
    out['points_mask'] = torch.stack([c[1] for c in clouds])
    gd = generator(seed, 'depth', device)
    lo, hi, _ = cfg.grid.depth
    depth = lo + (hi - 1e-3 - lo) * torch.rand((frames, N, H, W),
                                               generator=gd, **f32)
    hit = torch.rand((frames, N, H, W), generator=gd, **f32) < 0.02
    out['sparse_depth'] = torch.where(hit, depth, 0.0)
    if labels:
        gx, gy, gz = cfg.grid.grid_size
        glab = generator(seed, 'labels', device)
        out['segs'] = torch.randint(0, cfg.num_classes, (frames, N, H, W),
                                    generator=glab, device=device,
                                    dtype=torch.int32)
        out['voxel_semantics'] = torch.randint(
            0, cfg.num_classes, (frames, gx, gy, gz), generator=glab,
            device=device, dtype=torch.int32)
        out['mask_camera'] = torch.rand((frames, gx, gy, gz), generator=glab,
                                        **f32) > 0.3
    return out


def frame_fields(cfg, scene: Dict[str, torch.Tensor], t: int,
                 adjacent: List[int]) -> Dict[str, torch.Tensor]:
    """The fields of a ``Batch`` (batch 1) for key frame ``t`` with the
    temporal frames [t] + ``adjacent`` (frame indices of the scene): images
    of each, each camera's pose in the key frame's ego frame, and the key
    frame's LiDAR sweep, sparse depth, labels and ego pose."""
    dev = scene['imgs'].device
    N = cfg.num_cams
    rig = camera_rig(N, dev)
    frames = [t] + list(adjacent)
    e2g = scene['ego2global']
    key_inv = torch.linalg.inv(e2g[t].double())
    s2k = torch.stack([(key_inv @ e2g[f].double()).float() @ rig
                       for f in frames])
    K = intrinsics(cfg.input_size, dev)
    F_ = len(frames)
    imgs = scene['imgs'][t][None, None] if F_ == 1 else torch.stack(
        [scene['imgs'][f] for f in frames])[None]
    fields = dict(
        imgs=imgs, sensor2keyego=s2k[None],
        intrins=K.expand(1, F_, N, 3, 3),
        post_rots=torch.eye(3, device=dev).expand(1, F_, N, 3, 3),
        post_trans=torch.zeros(1, F_, N, 3, device=dev),
        bda=torch.eye(3, device=dev)[None],
        points=scene['points'][t][None],
        points_mask=scene['points_mask'][t][None],
        sparse_depth=scene['sparse_depth'][t][None],
        ego2global=e2g[t][None])
    for k in ('segs', 'voxel_semantics', 'mask_camera'):
        if k in scene:
            fields[k] = scene[k][t][None]
    return fields
