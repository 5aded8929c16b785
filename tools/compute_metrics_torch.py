"""Offline scoring of saved predictions, the PyTorch port's counterpart of
``tools/compute_metrics.py`` (same flags, same output).

Scores the ``pred_*.npz`` files (key ``occ_pred``) that ``tools/test_torch.py
--save-predictions`` writes against the ground truth of ``--ann-file``'s
samples, in timestamp order: mIoU (default), F-score and RayIoU, with the
port's ``eval/metrics.py`` and ``eval/ray_metrics.py`` on the host.

Usage:
  python3 tools/compute_metrics_torch.py --pred-dir preds/ \
      --ann-file data/nuscenes/fusionocc-nuscenes_infos_val.pkl \
      [--fscore] [--rayiou] [--buckets]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--pred-dir', required=True)
    ap.add_argument('--ann-file', required=True)
    ap.add_argument('--data-root', default='')
    ap.add_argument('--no-mask', action='store_true')
    ap.add_argument('--fscore', action='store_true')
    ap.add_argument('--rayiou', action='store_true')
    ap.add_argument('--buckets', action='store_true',
                    help='radius/height-bucketed mIoU tables')
    args = ap.parse_args(argv)

    import torch

    from fusionocc_tpu_torch.config import GridConfig
    from fusionocc_tpu_torch.eval.metrics import OccupancyMetric, fscore
    from fusionocc_tpu_torch.eval.ray_metrics import (RayIoUMetric,
                                                      rays_from_points)

    with open(args.ann_file, 'rb') as f:
        data = pickle.load(f)
    infos = sorted(data.get('data_list', data.get('infos')),
                   key=lambda e: e['timestamp'])

    pred_files = sorted(glob.glob(os.path.join(args.pred_dir, 'pred_*.npz')))
    assert pred_files, f'no predictions under {args.pred_dir}'

    grid = GridConfig()
    metric = OccupancyMetric(use_image_mask=not args.no_mask,
                             grid=grid if args.buckets else None)
    f_acc, n = [], 0
    ray_metric = RayIoUMetric(grid) if args.rayiou else None
    for pf, info in zip(pred_files, infos):
        pred = np.load(pf)['occ_pred']
        if pred.ndim == 4:
            pred = pred[0]
        occ_path = info['occ_path']
        if args.data_root and not os.path.isabs(occ_path):
            occ_path = os.path.join(args.data_root, occ_path)
        occ = np.load(os.path.join(occ_path, 'labels.npz'))
        gt = occ['semantics']
        mask = occ['mask_camera'].astype(bool)
        metric.update(torch.from_numpy(pred[None]).long(),
                      torch.from_numpy(gt[None]).long(),
                      mask_camera=torch.from_numpy(mask[None]))
        if args.fscore:
            f_acc.append(fscore(pred, gt, mask if not args.no_mask else None))
        if args.rayiou:
            pts = np.fromfile(
                info['lidar_path'] if os.path.isabs(info['lidar_path'])
                else os.path.join(args.data_root, info['lidar_path']),
                dtype=np.float32).reshape(-1, 5)
            ray_metric.update(pred, gt, rays_from_points(pts))
        n += 1

    res = metric.compute()
    res['samples'] = n
    if f_acc:
        res['fscore'] = round(float(np.mean([x['fscore'] for x in f_acc])), 4)
    if ray_metric is not None:
        # pooled tp/gt/pred counts across the dataset (the official
        # calc_metrics aggregation, not a mean of per-sample IoUs)
        res.update(ray_metric.compute())
    for k, v in res.items():
        print(f'{k}: {v}')
    print(json.dumps(res))


if __name__ == '__main__':
    main()
