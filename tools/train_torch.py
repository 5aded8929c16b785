"""Training CLI of the PyTorch port: the counterpart of ``tools/train.py``'s
``--synthetic`` branch.

    python3 tools/train_torch.py --synthetic --steps 10
    python3 tools/train_torch.py --tiny --synthetic --steps 2 --device cpu
    python3 tools/train_torch.py --synthetic --steps 20 --resume work_dirs/x

Every step trains on the synthetic batch of seed 0, as ``tools/train.py
--synthetic`` does; the schedule's epoch is ``--steps`` long.  ``--tiny``
takes the tiny model with the LiDAR encoder on the port's z-folded path
(``backend='zfold'``, ``zconv='zband'``); the default is the full model.
Checkpoints go to ``<work-dir>/step_<n>`` every ``--ckpt-interval-steps``
(0: once per epoch) and at the end; ``--resume`` takes a checkpoint or the
work dir holding them (its latest).  The nuScenes data pipeline is not
ported yet: without ``--synthetic`` the tool refuses to run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_config(tiny: bool, steps: int, lr, accumulate):
    from fusionocc_tpu_torch.config import (OptimConfig, TrainConfig,
                                            full_model_config,
                                            tiny_model_config)
    if tiny:
        model = tiny_model_config()
        model = dataclasses.replace(model, lidar=dataclasses.replace(
            model.lidar, backend='zfold', zconv='zband'))
    else:
        model = full_model_config()
    optim = dataclasses.replace(
        OptimConfig(), iters_per_epoch=max(steps, 1),
        **{k: v for k, v in (('lr', lr), ('accumulate_steps', accumulate))
           if v is not None})
    return TrainConfig(model=model, optim=optim)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--synthetic', action='store_true')
    ap.add_argument('--tiny', action='store_true', help='tiny model (debug)')
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--accumulate', type=int, default=None)
    ap.add_argument('--lr', type=float, default=None)
    ap.add_argument('--work-dir', default='./work_dirs/fusion_occ_torch')
    ap.add_argument('--resume', default=None)
    ap.add_argument('--ckpt-interval-steps', type=int, default=0,
                    help='0 = once per epoch')
    ap.add_argument('--log-interval', type=int, default=1)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if not args.synthetic:
        sys.exit('train_torch.py: the nuScenes data pipeline is not ported '
                 'yet (ROADMAP Queue A item 10); pass --synthetic')

    import torch

    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.train import checkpoint as ckpt
    from fusionocc_tpu_torch.train.loop import create_train_state, train_step

    cfg = build_config(args.tiny, args.steps, args.lr, args.accumulate)
    model = init_weights(FusionOcc(cfg.model, device=args.device),
                         torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg)
    if args.resume:
        path = ckpt.latest_checkpoint(args.resume) or args.resume
        ckpt.restore_checkpoint(path, model, state)
        print(f'resumed from {path} at step {state.step}', flush=True)
    batch = synthetic_batch(cfg.model, 1, 0, device=args.device)
    ckpt_every = args.ckpt_interval_steps or cfg.optim.iters_per_epoch
    sync = (torch.cuda.synchronize if torch.device(args.device).type == 'cuda'
            else (lambda: None))
    t0, first = time.perf_counter(), state.step
    while state.step < args.steps:
        logs = train_step(model, cfg, state, batch)
        if state.step % args.log_interval == 0 or state.step == first + 1:
            sync()
            dt = (time.perf_counter() - t0) / (state.step - first)
            line = ' '.join(f'{k}={float(v):.4f}' for k, v in logs.items())
            print(f'step {state.step}/{args.steps} {line} '
                  f'sec_per_iter={dt:.4f}', flush=True)
        if state.step % ckpt_every == 0 and state.step < args.steps:
            print(f'saved {ckpt.save_checkpoint(args.work_dir, model, state)}',
                  flush=True)
    path = ckpt.save_checkpoint(args.work_dir, model, state)
    print(f'final checkpoint: {path}', flush=True)


if __name__ == '__main__':
    main()
