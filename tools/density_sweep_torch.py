"""Capacity robustness on denser clouds, the PyTorch port's counterpart of
``tools/density_sweep.py`` (ROADMAP Queue C's C2).

The static capacities were tuned on the synthetic beam cloud; real
nuScenes density could exceed them.  This tool runs the LiDAR encoder's
index builds at 1x, 1.5x and 2x ``point_capacity`` (the beam cloud of
``synthetic_batch(seed=0)`` at the same scene extent: more points, more
occupied voxels) and prints, per density:

- per cut (voxels, then the super rows and the sparse stages' stride-2
  outputs, the JAX tool's stages 0-3) the rows kept against the capacity,
  the rows before the cut and those it drops, marked TRUNCATED where it
  drops any (``models.lidar_encoder.capacity_cuts``, the port's own
  builds);
- the LiDAR encoder's device ms, the median of 3 by CUDA events after a
  warm-up.

The beam cloud casts a fixed number of rays: at full size it keeps
101,434 points, below ``point_capacity``, so the three densities load one
cloud there (JAX's tool builds its densities the same way); the tiny
model's capacity binds.  The JAX tool's zwin bad-block column is left
out: zwin's window plan is not ported (ROADMAP, what is not ported).
Runs on the card unless ``--device`` names another; ``--tiny`` takes the
tiny model.

Usage:
  python3 tools/density_sweep_torch.py [--tiny] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCALES = (1.0, 1.5, 2.0)
REPS = 3


def density_config(cfg, scale: float):
    """``cfg`` with ``point_capacity`` times ``scale``."""
    return dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, point_capacity=int(cfg.lidar.point_capacity * scale)))


def stage_rows(cfg, points, points_mask) -> list:
    """Sample 0's rows per cut: (name, kept, before, capacity)."""
    from fusionocc_tpu_torch.models.lidar_encoder import capacity_cuts
    return [(name, min(int(n[0]), cap), int(n[0]), cap)
            for name, n, cap in capacity_cuts(cfg, points, points_mask)]


def encoder_ms(cfg, batch) -> list:
    """Device ms of ``REPS`` encoder passes after a warm-up (CUDA
    events)."""
    import torch

    from fusionocc_tpu_torch.models.fusion_occ import init_weights
    from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
    dev = batch.points.device
    enc = init_weights(SparseEncoder(cfg.lidar, cfg.grid, cfg.dtype, dev),
                       torch.Generator().manual_seed(0))
    ms = []
    with torch.inference_mode():
        enc(batch.points, batch.points_mask)
        for _ in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            enc(batch.points, batch.points_mask)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    return ms


def sweep(cfg, device, say=print) -> list:
    """Every density's rows and encoder ms (None off the card)."""
    import torch

    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    out = []
    for scale in SCALES:
        dcfg = density_config(cfg, scale)
        n_pts = dcfg.lidar.point_capacity
        b = synthetic_batch(dcfg, 1, 0, device=device)
        say(f'--- density x{scale}: {n_pts} points '
            f'({int(b.points_mask.sum())} in the cloud) ---')
        rows = stage_rows(dcfg, b.points, b.points_mask)
        for name, kept, before, cap in rows:
            trunc = ' TRUNCATED!' if before > cap else ''
            say(f'  {name}: {kept}/{cap} ({kept / cap:5.1%}), {before} '
                f'before the cut, {before - kept} dropped{trunc}')
        ms = (encoder_ms(dcfg, b) if torch.device(device).type == 'cuda'
              else None)
        say('  encoder e2e: ' + (
            f'{statistics.median(ms):9.2f} ms (device, median of {REPS} by '
            f'CUDA events after a warm-up; all {[round(t, 2) for t in ms]})'
            if ms else f'not measured on {device} (device time needs the '
            'card)'))
        out.append({'scale': scale, 'points': n_pts, 'rows': rows, 'ms': ms})
    say("  zwin bad-block column: not printed, zwin's window plan is not "
        'ported')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from fusionocc_tpu_torch.config import full_model_config
    from tools.test_torch import tiny_config
    sweep(tiny_config() if args.tiny else full_model_config(), args.device,
          say=lambda line: print(line, flush=True))


if __name__ == '__main__':
    main()
