"""Host data-loader throughput, the PyTorch port's counterpart of
``tools/bench_loader.py`` (same flags, same output).

Writes a file-backed nuScenes-shaped tree (full-resolution JPEGs, LiDAR
.bin sweeps, occupancy labels.npz, an infos pkl), then measures the port's
``data_loader`` over ``NuScenesOccDataset(train=True)`` at the full-size
config in samples/s at several worker counts: whether the host pipeline
can keep the card fed (the reference trains with workers_per_gpu=4,
configs/fusion_occ.py:317).

Usage: python3 tools/bench_loader_torch.py [--samples 16] [--keep DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAMS = ['CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
        'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT']


def make_fake_tree(root: str, n_samples: int, img_hw=(900, 1600),
                   n_points: int = 34000, occ_shape=(200, 200, 16),
                   seed: int = 0) -> str:
    """Write a dataset tree shaped like real nuScenes (sizes included)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    H, W = img_hw
    # one smooth base image per camera, jittered per sample: realistic JPEG
    # entropy (about 200-600 KB) without random-noise worst cases
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([(xx * 255 / W), (yy * 255 / H),
                     ((xx + yy) % 256)], -1).astype(np.float32)

    infos = []
    for i in range(n_samples):
        cams = {}
        for n, cam in enumerate(CAMS):
            img = base + rng.randn(8, 8, 3).repeat(H // 8 + 1, 0)[
                :H].repeat(W // 8 + 1, 1)[:, :W] * 40
            path = os.path.join(root, 'samples', cam, f'{i:04d}.jpg')
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                path, quality=90)
            yaw = 2 * np.pi * n / len(CAMS)
            cams[cam] = {
                'data_path': os.path.relpath(path, root),
                'cam_intrinsic': [[1266.0, 0, 800.0], [0, 1266.0, 450.0],
                                  [0, 0, 1]],
                'sensor2ego_rotation': [np.cos(yaw / 2), 0, 0,
                                        np.sin(yaw / 2)],
                'sensor2ego_translation': [1.0, 0.0, 1.5],
                'ego2global_rotation': [1, 0, 0, 0],
                'ego2global_translation': [i * 5.0, 0.0, 0.0],
            }
        lidar_path = os.path.join(root, 'samples', 'LIDAR_TOP',
                                  f'{i:04d}.bin')
        os.makedirs(os.path.dirname(lidar_path), exist_ok=True)
        pts = rng.randn(n_points, 5).astype(np.float32)
        pts[:, :2] *= 20.0
        pts[:, 2] = pts[:, 2] * 1.0 + 0.5
        pts[:, 4] = rng.randint(0, 32, n_points)  # ring index column
        pts.tofile(lidar_path)
        occ_dir = os.path.join(root, 'gts', 'scene-0001', f'tok{i}')
        os.makedirs(occ_dir, exist_ok=True)
        np.savez(os.path.join(occ_dir, 'labels.npz'),
                 semantics=rng.randint(0, 18, occ_shape).astype(np.uint8),
                 mask_camera=(rng.rand(*occ_shape) > 0.3).astype(np.uint8),
                 mask_lidar=(rng.rand(*occ_shape) > 0.3).astype(np.uint8))
        infos.append({
            'token': f'tok{i}', 'timestamp': 1000 + i,
            'scene_token': 'sc0', 'cams': cams,
            'occ_path': os.path.relpath(occ_dir, root),
            'lidar_path': os.path.relpath(lidar_path, root),
            'lidar2ego_rotation': [1, 0, 0, 0],
            'lidar2ego_translation': [0.9, 0.0, 1.8],
            'ego2global_rotation': [1, 0, 0, 0],
            'ego2global_translation': [i * 5.0, 0.0, 0.0],
        })
    ann = os.path.join(root, 'infos.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    return ann


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--samples', type=int, default=16)
    ap.add_argument('--batch-size', type=int, default=1)
    ap.add_argument('--workers', default='0,2,4,8')
    ap.add_argument('--keep', default=None,
                    help='build the tree here and keep it (default: tmp)')
    args = ap.parse_args(argv)

    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.dataset import (NuScenesOccDataset,
                                                  data_loader)

    root = args.keep or tempfile.mkdtemp(prefix='fusionocc_loader_')
    t0 = time.time()
    ann = make_fake_tree(root, args.samples)
    print(f'fake tree built in {time.time() - t0:.1f}s at {root}',
          flush=True)

    cfg = full_model_config()
    ds = NuScenesOccDataset(ann, cfg, data_root=root, train=True)
    results = {}
    for w in [int(x) for x in args.workers.split(',')]:
        n = 0
        t0 = time.time()
        for batch in data_loader(ds, args.batch_size, shuffle=False,
                                 num_workers=w):
            n += 1
        dt = time.time() - t0
        results[f'samples_per_sec_w{w}'] = round(
            n * args.batch_size / dt, 3)
        print(f'workers={w}: {n * args.batch_size / dt:.3f} samples/s '
              f'({dt:.1f}s total)', flush=True)
    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(results))


if __name__ == '__main__':
    main()
