"""Training burn-in, the PyTorch port's counterpart of ``tools/burnin.py``
(same flags, same output): N steps of the unified recipe with a loss-curve
artifact and a mid-run checkpoint-resume check.

The reference's unified recipe (configs/fusion_occ_occ3d_miou_unified.py:
279-289: gradient accumulation 8, backbone and view transformer at 0.1 of
the LR) on synthetic batches cycled through: the loss stays finite and,
over 50 steps or more, goes down; the checkpoint written at ``--ckpt-at``
(``train/checkpoint.py``) restores a state that replays the run's next
losses within 1e-3.  A step's random draws come from (seed, step), so the
replay draws what the run drew.  Runs on the card unless ``--device``
names another.

Usage:
  python3 tools/burnin_torch.py --steps 200 --out work_dirs/burnin
  python3 tools/burnin_torch.py --tiny --steps 8 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--out', default='/tmp/fusionocc_burnin')
    ap.add_argument('--ckpt-at', type=int, default=None,
                    help='save a checkpoint at this step (default steps//2)')
    ap.add_argument('--resume-check-steps', type=int, default=5)
    ap.add_argument('--accum', type=int, default=8)
    ap.add_argument('--num-batches', type=int, default=16,
                    help='distinct synthetic batches cycled through')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    ckpt_at = args.ckpt_at or args.steps // 2

    import math

    import torch

    from fusionocc_tpu_torch.config import OptimConfig, TrainConfig
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.train import checkpoint as ckpt
    from fusionocc_tpu_torch.train.loop import create_train_state, train_step
    from tools.train_torch import build_config

    preset = build_config(None, args.tiny, 1, None, None)
    # the unified recipe: accumulation, low LR on backbone + view transformer
    optim = OptimConfig(warmup_iters=20, iters_per_epoch=max(args.steps, 1),
                        max_epochs=1, accumulate_steps=args.accum,
                        backbone_lr_mult=0.1)
    cfg = TrainConfig(model=preset.model, optim=optim)

    n_pts = 512 if args.tiny else None
    batches = [synthetic_batch(cfg.model, 1, seed=s, num_points=n_pts,
                               device=args.device)
               for s in range(args.num_batches)]
    model = init_weights(FusionOcc(cfg.model, device=args.device),
                         torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg)

    os.makedirs(args.out, exist_ok=True)
    curve_path = os.path.join(args.out, 'loss_curve.jsonl')
    curve = open(curve_path, 'w')
    losses = []
    saved_tag = None
    t0 = time.time()
    for i in range(args.steps):
        logs = train_step(model, cfg, state, batches[i % len(batches)])
        loss = float(logs['loss'])
        losses.append(loss)
        rec = {'step': i + 1, 'loss': round(loss, 4),
               'loss_occ': round(float(logs['loss_occ']), 4),
               'depth_loss': round(float(logs['depth_loss']), 5),
               'seg_loss': round(float(logs['seg_loss']), 5),
               'grad_norm': round(float(logs['grad_norm']), 3),
               't': round(time.time() - t0, 1)}
        curve.write(json.dumps(rec) + '\n')
        curve.flush()
        if (i + 1) % 10 == 0 or i == 0:
            print(rec, flush=True)
        assert math.isfinite(loss), f'non-finite loss at step {i + 1}'
        if i + 1 == ckpt_at:
            saved_tag = ckpt.save_checkpoint(args.out, model, state)
            print(f'checkpoint saved: {saved_tag}', flush=True)
    curve.close()

    steps_per_sec = args.steps / (time.time() - t0)
    n = max(args.steps // 10, 1)
    first = sum(losses[:n]) / len(losses[:n])
    last = sum(losses[-n:]) / len(losses[-n:])
    print(f'steps/sec: {steps_per_sec:.3f}  loss {first:.3f} -> {last:.3f}')
    if args.steps >= 50:   # short smoke runs can't out-train the warmup
        assert last < first, ('loss did not decrease over the burn-in: '
                              f'{first:.4f} -> {last:.4f}')

    # ---- mid-run resume consistency --------------------------------------
    if saved_tag is not None and ckpt_at < args.steps:
        ckpt.restore_checkpoint(saved_tag, model, state)
        n_chk = min(args.resume_check_steps, args.steps - ckpt_at)
        replay = []
        for i in range(ckpt_at, ckpt_at + n_chk):
            logs = train_step(model, cfg, state, batches[i % len(batches)])
            replay.append(float(logs['loss']))
        orig = losses[ckpt_at:ckpt_at + n_chk]
        err = max(abs(a - b) for a, b in zip(orig, replay))
        print(f'resume replay max |dloss| over {n_chk} steps: {err:.2e}')
        assert err < 1e-3, (orig, replay)

    print(json.dumps({'metric': 'burnin_steps_per_sec',
                      'value': round(steps_per_sec, 3),
                      'loss_first': round(first, 4),
                      'loss_last': round(last, 4),
                      'resume_ok': saved_tag is not None}))


if __name__ == '__main__':
    main()
