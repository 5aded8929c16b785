"""RayIoU: ray-casting occupancy metric with exact voxel traversal.

The port's copy of ``fusionocc_tpu/eval/ray_metrics.py``, host float64
numpy as there.  The grid's bounds and steps enter as float32 values, as
JAX's ``GridConfig`` gives them, so the two render the same rays.

The reference exposes RayIoU through a registry swap into STCOcc's evaluator
(fusionocc/occupancy_metric_hybrid.py:10-154); the metric itself is defined
by the DVR CUDA renderer + calc_metrics
(projects/STCOcc/stcocc/datasets/ray_metrics_occ3d.py:110-235,
stcocc/libs/dvr/dvr.cu:70-308).  This is a re-derivation with the SAME
semantics, validated against a direct numpy port of the official traversal
in tests/test_ray_metrics.py:

  - Amanatides-Woo voxel traversal from the ray origin: the renderer
    records, for every voxel the ray passes through, the distance at which
    the ray EXITS it (dvr.cu:184-236).
  - The reported hit is the first traversed voxel with occupancy > 0.5;
    its class labels the ray and its exit distance is the ray depth
    (dvr.cu:269-284).
  - A ray that crosses the grid without hitting anything still participates:
    it is labeled by its LAST traversed voxel (free class) at the grid-exit
    distance (dvr.cu:264-267) — so a prediction that fills an empty GT ray
    becomes a false positive, and vice versa.
  - calc_metrics (ray_metrics_occ3d.py:187-235): per threshold t in
    {1, 2, 4} m, TP_c = #rays with gt label == pred label == c and
    |d_pred - d_gt| < t; IoU_c = TP / (gt_cnt + pred_cnt - TP); the free
    class is excluded; RayIoU = mean over thresholds of the class nanmean.

Instead of marching a sequential DDA, the traversal is vectorized: each
axis's boundary-crossing distances form an arithmetic sequence, and the
visited-voxel sequence is the three sequences MERGED — one per-ray sort
(with the official tie order Z before Y before X, dvr.cu:210-231) yields
every voxel's exit distance and identity in closed form.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..config import GridConfig


# official lidar origin in the key ego frame (ray_metrics_occ3d.py:111)
LIDAR_ORIGIN = (0.9858, 0.0, 1.8402)


def rays_from_points(points: np.ndarray, origin=LIDAR_ORIGIN,
                     max_rays: int = 8192, seed: int = 0) -> np.ndarray:
    """Unit ray directions from `origin` through (a subsample of) points.

    The default origin matches render_rays / ray_iou so that rays built
    from lidar returns actually pass through those returns when cast."""
    rng = np.random.RandomState(seed)
    pts = points[:, :3] - np.asarray(origin)
    norm = np.linalg.norm(pts, axis=1)
    keep = norm > 1e-3
    pts = pts[keep] / norm[keep][:, None]
    if len(pts) > max_rays:
        pts = pts[rng.choice(len(pts), max_rays, replace=False)]
    elif len(pts) < max_rays:
        pad = pts[rng.choice(len(pts), max_rays - len(pts))]
        pts = np.concatenate([pts, pad], axis=0)
    return pts.astype(np.float32)


def generate_lidar_rays() -> np.ndarray:
    """The official evaluation ray fan (ray_metrics_occ3d.py:83-106).

    Pitch angles follow the nuScenes lidar: -(pi/2 - atan(k+1)) for k<10,
    then extended upward with the last spacing until +0.21 rad; azimuth
    sweeps 0..359 deg in 1 deg steps.
    """
    import math
    pitch = [-(math.pi / 2 - math.atan(k + 1)) for k in range(10)]
    while pitch[-1] < 0.21:
        pitch.append(pitch[-1] + (pitch[-1] - pitch[-2]))
    rays = []
    for p in pitch:
        for az_deg in np.arange(0, 360, 1):
            az = np.deg2rad(az_deg)
            rays.append((np.cos(p) * np.cos(az), np.cos(p) * np.sin(az),
                         np.sin(p)))
    return np.asarray(rays, np.float32)

def render_rays(occ, origin, dirs, grid: GridConfig, free_class: int = 17):
    """Exact-traversal ray rendering of an (X, Y, Z) class grid.

    Returns (label, dist_m, entered) per ray with the DVR renderer's
    semantics (see module docstring).  `entered` is False for rays that
    never intersect the grid (cannot happen for an interior origin).

    Host-side float64 numpy: the official renderer computes in double
    (dvr.cu:115-170) and this is offline evaluation tooling — f32 would
    jitter exit distances and corner tie-breaks against the reference.
    """
    occ = np.asarray(occ)
    gx, gy, gz = grid.grid_size
    sizes = np.asarray([gx, gy, gz], np.int64)
    lower = np.float32(grid.lower_bound).astype(np.float64)
    interval = np.float32(grid.interval).astype(np.float64)
    o_vox = (np.asarray(origin, np.float64) - lower) / interval     # (3,)
    d = np.asarray(dirs, np.float64)                                # (R, 3)
    dv = d / interval                                               # vox/m
    R = d.shape[0]

    # Advance exterior origins to just before grid entry (slab test):
    # only K crossings per axis are enumerated, so a far-outside origin
    # would exhaust them before reaching the grid and silently render as
    # never-entered.  Interior origins get t0 = 0 (bit-identical path).
    with np.errstate(divide='ignore', invalid='ignore'):
        t_lo = (0.0 - o_vox[None, :]) / dv                          # (R, 3)
        t_hi = (sizes[None, :].astype(np.float64) - o_vox[None, :]) / dv
    para = dv == 0.0
    t_near = np.where(para, -np.inf, np.minimum(t_lo, t_hi))
    t_far = np.where(para, np.inf, np.maximum(t_lo, t_hi))
    miss_para = para & ((o_vox[None, :] < 0)
                        | (o_vox[None, :] > sizes[None, :]))
    t_enter = t_near.max(axis=1)                                    # (R,)
    t_exit = np.where(miss_para.any(axis=1), -np.inf, t_far.min(axis=1))
    hits_box = (t_enter <= t_exit) & (t_exit >= 0)
    # back off one fastest-axis voxel so the shifted origin stays outside
    t_back = 1.0 / np.max(np.abs(dv), axis=1)
    t0 = np.where(hits_box, np.maximum(0.0, t_enter - t_back), 0.0)
    o_r = o_vox[None, :] + t0[:, None] * dv                         # (R, 3)

    # K crossings per axis cover any chord through the grid (+ the few
    # pre-entry crossings left after the back-off)
    Ks = [int(s) + 4 for s in sizes]
    v0 = np.floor(o_r).astype(np.int64)                             # (R, 3)

    ts_list, axis_list, step_list = [], [], []
    for a in range(3):
        dva = dv[:, a]                                              # (R,)
        step = np.where(dva >= 0, 1, -1).astype(np.int64)
        b0 = v0[:, a] + np.where(step < 0, 0, 1)
        with np.errstate(divide='ignore'):
            tmax = np.where(dva == 0, np.inf, (b0 - o_r[:, a]) / dva)
            tdelta = np.where(dva == 0, np.inf, np.abs(1.0 / dva))
        i = np.arange(Ks[a], dtype=np.float64)
        with np.errstate(invalid='ignore'):   # inf tdelta for axis-0 dirs
            ts_list.append(tmax[:, None] + i[None, :] * tdelta[:, None])
        axis_list.append(np.full((R, Ks[a]), a, np.int64))
        step_list.append(np.broadcast_to(step[:, None], (R, Ks[a])))

    ts = np.concatenate(ts_list, axis=1)                            # (R, K)
    axes = np.concatenate(axis_list, axis=1)
    steps = np.concatenate(step_list, axis=1)
    # official tie order on exact corner crossings: Z, then Y, then X
    # (dvr.cu:210-231) — secondary sort key x->2, y->1, z->0
    prio = 2 - axes
    order = np.lexsort((prio, ts), axis=1)
    ts_s = np.take_along_axis(ts, order, axis=1)
    axes_s = np.take_along_axis(axes, order, axis=1)
    steps_s = np.take_along_axis(steps, order, axis=1)

    # voxel of segment i = v0 + sum of steps of crossings j < i
    oh = (axes_s[..., None] == np.arange(3)) * steps_s[..., None]
    moved = np.cumsum(oh, axis=1) - oh                              # exclusive
    vox = v0[:, None, :] + moved                                    # (R, K, 3)
    inside = np.all((vox >= 0) & (vox < sizes), axis=-1)
    inside &= np.isfinite(ts_s)

    flat = np.clip((vox[..., 0] * gy + vox[..., 1]) * gz + vox[..., 2],
                   0, gx * gy * gz - 1)
    cls = occ.reshape(-1)[flat]                                     # (R, K)
    hit = inside & (cls != free_class)

    entered = np.any(inside, axis=1)
    first_hit = np.argmax(hit, axis=1)
    any_hit = np.any(hit, axis=1)
    # last inside segment (grid exit): K-1 - argmax(reversed inside)
    last_in = inside.shape[1] - 1 - np.argmax(inside[:, ::-1], axis=1)
    pick = np.where(any_hit, first_hit, last_in)
    label = np.take_along_axis(cls, pick[:, None], axis=1)[:, 0]
    # distances are measured from the CALLER's origin: add back the
    # exterior-origin advance t0 (zero for interior origins)
    dist = t0 + np.take_along_axis(ts_s, pick[:, None], axis=1)[:, 0]
    label = np.where(entered, label, free_class).astype(np.int32)
    dist = np.where(entered, dist, 0.0).astype(np.float64)
    return label, dist, entered


class RayIoUMetric:
    """Streaming RayIoU accumulator over samples (calc_metrics semantics).

    update() renders pred and GT with the exact traversal and accumulates
    gt/pred/tp counts; compute() returns per-threshold mIoU and the
    headline mean, exactly as ray_metrics_occ3d.calc_metrics aggregates
    across the dataset.
    """

    def __init__(self, grid: GridConfig, num_classes: int = 18,
                 free_class: int = 17,
                 thresholds: Sequence[float] = (1.0, 2.0, 4.0)):
        self.grid = grid
        self.num_classes = num_classes
        self.free_class = free_class
        self.thresholds = tuple(thresholds)
        self.gt_cnt = np.zeros(num_classes, np.float64)
        self.pred_cnt = np.zeros(num_classes, np.float64)
        self.tp_cnt = np.zeros((len(self.thresholds), num_classes),
                               np.float64)

    def update(self, pred, gt, dirs, origin=LIDAR_ORIGIN):
        lp, dp, _ = render_rays(pred, origin, dirs, self.grid,
                                self.free_class)
        lg, dg, _ = render_rays(gt, origin, dirs, self.grid,
                                self.free_class)
        self.gt_cnt += np.bincount(lg, minlength=self.num_classes)
        self.pred_cnt += np.bincount(lp, minlength=self.num_classes)
        same = lp == lg
        err = np.abs(dp - dg)
        for j, thr in enumerate(self.thresholds):
            m = same & (err < thr)
            self.tp_cnt[j] += np.bincount(lg[m],
                                          minlength=self.num_classes)

    def compute(self) -> Dict[str, float]:
        out = {}
        mious = []
        # free class excluded from the mean (calc_metrics drops it via
        # [:-1]; honor free_class wherever it sits)
        sem = np.arange(self.num_classes) != self.free_class
        with np.errstate(divide='ignore', invalid='ignore'):
            for j, thr in enumerate(self.thresholds):
                iou = self.tp_cnt[j][sem] / (
                    self.gt_cnt[sem] + self.pred_cnt[sem]
                    - self.tp_cnt[j][sem])
                miou = float(np.nanmean(iou))
                out[f'RayIoU@{thr}'] = round(miou * 100, 2)
                mious.append(miou)
        out['RayIoU'] = round(float(np.mean(mious)) * 100, 2)
        return out


def ray_iou(pred: np.ndarray, gt: np.ndarray, dirs: np.ndarray,
            grid: GridConfig, origin=LIDAR_ORIGIN,
            thresholds: Sequence[float] = (1.0, 2.0, 4.0),
            num_classes: int = 18, free_class: int = 17) -> Dict[str, float]:
    """Single-sample RayIoU (exact traversal, official aggregation)."""
    m = RayIoUMetric(grid, num_classes, free_class, thresholds)
    m.update(pred, gt, dirs, origin)
    return m.compute()
