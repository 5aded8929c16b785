"""Offline generation of 2D seg-label maps and depth GT from nuScenes, the
PyTorch port's counterpart of ``tools/gen_seg_depth.py`` (same flags, same
outputs): lidarseg class labels projected onto the cameras at 1/8
resolution (remapped to the 18-class occupancy taxonomy) and per-camera
depth maps over a pool of ``--workers`` processes, with the port's
``data/pipeline.points_to_depthmap_np`` and ``geometry.pose_matrix``.

Usage:
  python3 tools/gen_seg_depth_torch.py --root data/nuscenes \
      --version v1.0-trainval \
      --infos data/nuscenes/fusionocc-nuscenes_infos_train.pkl --what seg
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fusionocc_tpu_torch.data.pipeline import points_to_depthmap_np  # noqa: E402
from fusionocc_tpu_torch.geometry import pose_matrix  # noqa: E402

# nuScenes lidarseg (32 classes) -> occupancy 18-class taxonomy
# (index = raw lidarseg id). Standard Occ3D mapping.
LIDARSEG_TO_OCC = np.array([
    0,   # 0 noise -> others
    0, 7, 7, 7, 0, 7, 0, 0, 1, 0,  # animal, adult, child, cone?, ...
    0, 8, 0, 2, 3, 3, 4, 5, 0, 0,
    6, 9, 10, 11, 12, 13, 14, 15, 0, 16,
    0, 0,
], dtype=np.uint8)
# Canonical mapping for the 16 semantic classes:
_MAP = {1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 0: 0,
        29: 0, 31: 0, 9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6,
        2: 7, 3: 7, 4: 7, 6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12,
        26: 13, 27: 14, 28: 15, 30: 16}
LIDARSEG_TO_OCC = np.zeros(32, np.uint8)
for k, v in _MAP.items():
    LIDARSEG_TO_OCC[k] = v


def _lidar2cam_chain(info, cam_info):
    l2e = pose_matrix(info['lidar2ego_rotation'], info['lidar2ego_translation'])
    le2g = pose_matrix(info['ego2global_rotation'],
                       info['ego2global_translation'])
    c2e = pose_matrix(cam_info['sensor2ego_rotation'],
                      cam_info['sensor2ego_translation'])
    ce2g = pose_matrix(cam_info['ego2global_rotation'],
                       cam_info['ego2global_translation'])
    return np.linalg.inv(ce2g @ c2e) @ le2g @ l2e


def process_sample(args):
    info, root, lidarseg_map, what, out_dirs, src_hw = args
    pts = np.fromfile(info['lidar_path'], dtype=np.float32).reshape(-1, 5)
    seg_labels = None
    if what in ('seg', 'both'):
        seg_path = lidarseg_map.get(
            info['cams']['CAM_FRONT'].get('sample_data_token_lidar',
                                          info['token']))
        # lidarseg file is keyed by the LIDAR_TOP sample_data token
        lp = os.path.basename(info['lidar_path'])
        cand = os.path.join(root, 'lidarseg', lidarseg_map.get(
            info['token'], '')) if lidarseg_map else None
        if cand and os.path.exists(cand):
            raw = np.fromfile(cand, dtype=np.uint8)
            seg_labels = LIDARSEG_TO_OCC[np.clip(raw, 0, 31)]
    H, W = src_hw
    for cam, ci in info['cams'].items():
        l2c = _lidar2cam_chain(info, ci)
        intr = np.asarray(ci['cam_intrinsic'], np.float64)
        campts = pts[:, :3] @ l2c[:3, :3].T + l2c[:3, 3]
        front = campts[:, 2] > 0.1
        uv = (campts[:, :2] / campts[:, 2:3])
        uv = uv @ intr[:2, :2].T + intr[:2, 2]
        uvd = np.concatenate([uv, campts[:, 2:3]], 1)[front]
        rel = os.path.relpath(ci['data_path'], root)
        if what in ('depth', 'both'):
            dm = points_to_depthmap_np(uvd.astype(np.float32), H, W,
                                       (1.0, 100.0))
            out = os.path.join(out_dirs['depth'], rel.replace('.jpg', '.npy'))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.save(out, dm)
        if what in ('seg', 'both') and seg_labels is not None:
            lbl = seg_labels[front]
            h8, w8 = H // 8, W // 8
            seg_map = np.full((h8, w8), 17, np.uint8)
            u8 = np.round(uvd[:, 0] / 8).astype(np.int64)
            v8 = np.round(uvd[:, 1] / 8).astype(np.int64)
            keep = (u8 >= 0) & (u8 < w8) & (v8 >= 0) & (v8 < h8)
            order = np.argsort(-uvd[keep, 2])  # nearest written last
            seg_map[v8[keep][order], u8[keep][order]] = lbl[keep][order]
            out = os.path.join(out_dirs['seg'], rel.replace('.jpg', '.npy'))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.save(out, seg_map)
    return info['token']


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--version', default='v1.0-trainval')
    ap.add_argument('--infos', required=True)
    ap.add_argument('--what', choices=['seg', 'depth', 'both'], default='both')
    ap.add_argument('--workers', type=int, default=8)
    ap.add_argument('--src-h', type=int, default=900)
    ap.add_argument('--src-w', type=int, default=1600)
    args = ap.parse_args(argv)

    with open(args.infos, 'rb') as f:
        infos = pickle.load(f)['data_list']

    lidarseg_map = {}
    lspath = os.path.join(args.root, args.version, 'lidarseg.json')
    if os.path.exists(lspath):
        with open(lspath) as f:
            for row in json.load(f):
                lidarseg_map[row['sample_data_token']] = row['filename']

    out_dirs = {'seg': os.path.join(args.root, 'imgseg'),
                'depth': os.path.join(args.root, 'depth_gt')}
    tasks = [(i, args.root, lidarseg_map, args.what, out_dirs,
              (args.src_h, args.src_w)) for i in infos]
    with mp.Pool(args.workers) as pool:
        for n, _ in enumerate(pool.imap_unordered(process_sample, tasks)):
            if (n + 1) % 500 == 0:
                print(f'{n + 1}/{len(tasks)}', flush=True)
    print('done')


if __name__ == '__main__':
    main()
