"""Occupancy visualization CLI of the PyTorch port: the counterpart of
``tools/visualize.py``.

BEV comparison images (and optionally a video) from the prediction dumps
that ``tools/test_torch.py --save-predictions`` writes (``pred_*.npz``,
key ``occ_pred``), beside the ground truth of ``--ann-file``'s samples
when their ``labels.npz`` exist.  Runs on the host; needs matplotlib.

Usage:
  python3 tools/visualize_torch.py --pred-dir preds/ --ann-file infos_val.pkl \
      --out-dir vis/ [--video vis/occ.gif]
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--pred-dir', required=True)
    ap.add_argument('--ann-file', default=None)
    ap.add_argument('--data-root', default='')
    ap.add_argument('--out-dir', default='vis')
    ap.add_argument('--video', default=None, help='also write an mp4/gif')
    ap.add_argument('--max-samples', type=int, default=0)
    args = ap.parse_args(argv)

    from fusionocc_tpu_torch.utils.visualization import (
        occupancy_bev_image, save_occupancy_figure)

    infos = None
    if args.ann_file:
        with open(args.ann_file, 'rb') as f:
            data = pickle.load(f)
        infos = sorted(data.get('data_list', data.get('infos')),
                       key=lambda e: e['timestamp'])

    files = sorted(glob.glob(os.path.join(args.pred_dir, 'pred_*.npz')))
    if args.max_samples:
        files = files[:args.max_samples]
    os.makedirs(args.out_dir, exist_ok=True)

    frames = []
    for i, pf in enumerate(files):
        pred = np.load(pf)['occ_pred']
        if pred.ndim == 4:
            pred = pred[0]
        gt = None
        if infos is not None and i < len(infos):
            occ_path = infos[i]['occ_path']
            if args.data_root and not os.path.isabs(occ_path):
                occ_path = os.path.join(args.data_root, occ_path)
            lbl = os.path.join(occ_path, 'labels.npz')
            if os.path.exists(lbl):
                gt = np.load(lbl)['semantics']
        out = os.path.join(args.out_dir, f'occ_{i:06d}.png')
        save_occupancy_figure(pred, out, gt=gt, title=f'sample {i}')
        if args.video:
            frames.append(occupancy_bev_image(pred))
    print(f'{len(files)} figures -> {args.out_dir}')

    if args.video and frames:
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.animation as anim
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6, 6))
            ax.set_axis_off()
            im = ax.imshow(frames[0])

            def update(k):
                im.set_data(frames[k])
                return [im]

            a = anim.FuncAnimation(fig, update, frames=len(frames),
                                   interval=100)
            # a writer instance carries its own fps (matplotlib refuses
            # both, which tools/visualize.py passes for a .gif)
            if args.video.endswith('.gif'):
                a.save(args.video, writer=anim.PillowWriter(fps=10))
            else:
                a.save(args.video, fps=10)
            plt.close(fig)
            print(f'video -> {args.video}')
        except Exception as e:  # noqa: BLE001
            print(f'video writing failed ({e}); figures are still available')


if __name__ == '__main__':
    main()
