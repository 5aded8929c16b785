"""Time the port's full-size two-pass ``predict`` from a given source tree.

    python3 tools/ab_torch_predict.py [--root DIR] [--reps 20] [--label X]

Imports ``fusionocc_tpu_torch`` from ``--root`` (default: this checkout),
so one call can time two trees in turn (parent, change, change, parent):
the default config, bf16, seeded random weights, the synthetic batches of
seeds 0-2 with their pooling indices cached, 3 warm-up predicts, then
``--reps`` predicts, each timed by CUDA events and by the host clock
around it.  Prints one JSON line: the label, the card's ``nvidia-smi``
name and power limit, the median and all ms, and the kernels' launches
per predict.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--label', default='')
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, init_weights)
    from fusionocc_tpu_torch.ops.kernels import KERNELS

    cfg = full_model_config()
    model = init_weights(FusionOcc(cfg, device='cuda'),
                         torch.Generator().manual_seed(0))
    batches = [synthetic_batch(cfg, 1, s, device='cuda') for s in (0, 1, 2)]
    idxs = batch_pooling_indices(cfg, batches[0])
    for b in batches:
        model.predict(b, idxs)
    torch.cuda.synchronize()
    KERNELS.reset_counts()
    dev_ms, wall_ms = [], []
    for i in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        model.predict(batches[i % 3], idxs)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        'label': args.label, 'root': os.path.abspath(args.root),
        'card': card, 'reps': args.reps,
        'ms_median': statistics.median(dev_ms),
        'wall_ms_median': statistics.median(wall_ms),
        'ms': [round(t, 3) for t in dev_ms],
        'launches_per_predict': {k: v // args.reps
                                 for k, v in KERNELS.launches.items() if v},
    }))


if __name__ == '__main__':
    main()
