"""Training-log analysis, the PyTorch port's counterpart of
``tools/analyze_logs.py`` (same flags, same output): a summary, and with
``--plot`` a plot, of the ``scalars.jsonl`` that ``tools/train_torch.py``
writes.

Usage:
  python3 tools/analyze_logs_torch.py --work-dir work_dirs/fusion_occ_torch \
      [--plot out.png]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--work-dir', required=True)
    ap.add_argument('--keys', default='train/loss,train/loss_occ')
    ap.add_argument('--plot', default=None)
    args = ap.parse_args(argv)

    from fusionocc_tpu_torch.utils.logging import load_scalars
    recs = load_scalars(args.work_dir)
    if not recs:
        print('no records')
        return
    keys = args.keys.split(',')
    print(f'{len(recs)} records, steps {recs[0]["step"]}..{recs[-1]["step"]}')
    for k in keys:
        vals = [(r['step'], r[k]) for r in recs if k in r]
        if not vals:
            print(f'{k}: (absent)')
            continue
        v = [x[1] for x in vals]
        print(f'{k}: first={v[0]:.4f} last={v[-1]:.4f} '
              f'min={min(v):.4f} max={max(v):.4f}')
    if 'train/sec_per_iter' in recs[-1]:
        print(f"avg sec/iter: {recs[-1]['train/sec_per_iter']:.3f}")

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 5))
        for k in keys:
            vals = [(r['step'], r[k]) for r in recs if k in r]
            if vals:
                ax.plot([x[0] for x in vals], [x[1] for x in vals], label=k)
        ax.set_xlabel('step')
        ax.legend()
        ax.grid(alpha=0.3)
        fig.savefig(args.plot, dpi=120)
        print(f'plot -> {args.plot}')


if __name__ == '__main__':
    main()
