"""Occ3D ground-truth statistics, the PyTorch port's counterpart of
``tools/analyze_occ_gt.py`` (same flags, same output): per-class voxel
counts in the ego-distance ranges 0-20 m, 20-35 m and 35 m+ (voxel-centre
XY radius on the 0.4 m Occ3D grid) and the camera-mask coverage, over the
``labels.npz`` of an infos pkl's samples, with the port's class names.

Usage:
    python3 tools/analyze_occ_gt_torch.py --ann-file infos_train.pkl \
        [--data-root data/nuscenes] [--max-samples N]
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fusionocc_tpu_torch.eval.metrics import CLASS_NAMES  # noqa: E402

DIST_BINS = (0.0, 20.0, 35.0, np.inf)
DIST_LABELS = ('0-20m', '20-35m', '35m+')


def distance_bucket_grid(shape, voxel_size=0.4):
    """Per-voxel distance-bin id; XY radius from the grid center (the
    reference centers on W/2, H/2 rather than a point-cloud range)."""
    W, H, D = shape
    xs = (np.arange(W) + 0.5 - W / 2.0) * voxel_size
    ys = (np.arange(H) + 0.5 - H / 2.0) * voxel_size
    r = np.sqrt(xs[:, None] ** 2 + ys[None, :] ** 2)
    bid = np.digitize(r, DIST_BINS[1:-1]).astype(np.int32)
    return np.broadcast_to(bid[:, :, None], (W, H, D))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--ann-file', required=True)
    ap.add_argument('--data-root', default='')
    ap.add_argument('--max-samples', type=int, default=0)
    args = ap.parse_args(argv)

    with open(args.ann_file, 'rb') as f:
        data = pickle.load(f)
    infos = data.get('data_list', data.get('infos'))
    if args.max_samples:
        infos = infos[:args.max_samples]

    n_cls = len(CLASS_NAMES)
    counts = np.zeros((len(DIST_LABELS), n_cls), np.int64)
    masked_counts = np.zeros((len(DIST_LABELS), n_cls), np.int64)
    mask_voxels = total_voxels = 0
    bid = None

    for i, info in enumerate(infos):
        occ_path = info['occ_path']
        if args.data_root and not os.path.isabs(occ_path):
            occ_path = os.path.join(args.data_root, occ_path)
        occ = np.load(os.path.join(occ_path, 'labels.npz'))
        sem = occ['semantics']
        mask = occ['mask_camera'].astype(bool)
        if bid is None or bid.shape != sem.shape:
            bid = distance_bucket_grid(sem.shape)
        for b in range(len(DIST_LABELS)):
            sel = bid == b
            counts[b] += np.bincount(sem[sel].ravel(), minlength=n_cls)[:n_cls]
            masked_counts[b] += np.bincount(
                sem[sel & mask].ravel(), minlength=n_cls)[:n_cls]
        mask_voxels += int(mask.sum())
        total_voxels += mask.size
        if (i + 1) % 100 == 0:
            print(f'# {i + 1}/{len(infos)}', flush=True)

    print(f'samples: {len(infos)}  camera-mask coverage: '
          f'{mask_voxels / max(total_voxels, 1):.3%}')
    hdr = f'{"class":22s}' + ''.join(f'{d:>14s}' for d in DIST_LABELS) \
        + f'{"total":>16s}'
    print('\n== all voxels ==')
    print(hdr)
    for c in range(n_cls):
        row = ''.join(f'{counts[b, c]:14d}' for b in range(len(DIST_LABELS)))
        print(f'{CLASS_NAMES[c]:22s}{row}{counts[:, c].sum():16d}')
    print('\n== camera-masked voxels ==')
    print(hdr)
    for c in range(n_cls):
        row = ''.join(f'{masked_counts[b, c]:14d}'
                      for b in range(len(DIST_LABELS)))
        print(f'{CLASS_NAMES[c]:22s}{row}{masked_counts[:, c].sum():16d}')


if __name__ == '__main__':
    main()
