"""Training CLI of the PyTorch port: the counterpart of ``tools/train.py``.

    python3 tools/train_torch.py --ann-file data/nuscenes/fusionocc-nuscenes_infos_train.pkl \
        --img-seg-dir data/nuscenes/img_seg --config fusion_occ_unified \
        --load-from swin_base_patch4_window12_384_22k.pth --steps 0
    python3 tools/train_torch.py --synthetic --steps 10
    python3 tools/train_torch.py --tiny --synthetic --steps 2 --device cpu
    python3 tools/train_torch.py --synthetic --steps 20 --resume work_dirs/x
    torchrun --nproc_per_node 8 tools/train_torch.py --synthetic --steps 10
    torchrun --standalone --nproc_per_node 2 tools/train_torch.py --tiny \
        --synthetic --steps 2 --device cpu

``--config`` takes a preset of ``fusionocc_tpu_torch.configs`` (default
``fusion_occ``; ``--tiny`` alone: ``tiny``, whose LiDAR encoder runs on the
port's z-folded path, ``backend='zfold'``, ``zconv='zband'``).  With
``--ann-file`` the port's ``NuScenesOccDataset(train=True)`` feeds the
steps through ``data_loader`` (shuffled by epoch, 4 threads) and
``prefetch``, each epoch with its own augmentations (``set_epoch``); the
schedule's epoch is the dataset's length over the batch size.  With
``--synthetic`` every step trains on the synthetic batch of seed 0 and the
epoch is ``--steps`` long.  ``--load-from`` warm-starts the image backbone
from an official Swin checkpoint (``weights.load_official_swin``).
The defaults are the JAX tool's: ``--steps 0`` runs the whole schedule
(with ``--synthetic``, an epoch of one step), ``--log-interval 50`` logs
the first step and every 50th.  Scalars go to ``<work-dir>/scalars.jsonl``
and, when ``tensorboardX`` is installed, to TensorBoard under
``<work-dir>/tb``; with ``--render-interval N`` a BEV render of
the EMA prediction of the step's batch goes to
``<work-dir>/images/train_bev_pred_<step>.png`` every N steps
(``MetricLogger.log_image``); checkpoints to ``<work-dir>/step_<n>`` every
``--ckpt-interval-steps`` (0: once per epoch) and at the end; ``--resume``
takes a checkpoint or the work dir holding them (its latest).

Over several processes (``torchrun``, ``tools/launch_torch_multihost.sh``,
or the JAX tool's ``--coordinator``/``--num-processes``/``--process-id``)
the process group is joined before anything touches the card, one card per
local rank (NCCL; gloo with ``--device cpu``).  ``--batch-size`` is each
rank's: the global batch is that times the world size.  With
``--synthetic`` each rank trains on its rows of the global synthetic batch
of seed 0; with ``--ann-file`` each rank reads its shard of the shuffled
order (``data_loader(host_id=rank, host_count=world)``), an epoch being
``len(dataset) // (batch_size * world)`` steps on every rank.  Rank 0 alone
prints, writes ``scalars.jsonl`` and the checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_config(config, tiny: bool, iters_per_epoch: int, lr, accumulate,
                 epochs=None, batch_size: int = 1):
    """The preset's ``TrainConfig`` with the schedule and overrides of the
    command line; the tiny preset's LiDAR encoder on the z-folded path."""
    from fusionocc_tpu_torch.config import TrainConfig
    from fusionocc_tpu_torch.configs import get_config
    preset = get_config(config or ('tiny' if tiny else 'fusion_occ'))
    model = preset.model
    if model.lidar.backend != 'zfold':
        model = dataclasses.replace(model, lidar=dataclasses.replace(
            model.lidar, backend='zfold', zconv='zband'))
    optim = dataclasses.replace(
        preset.optim, iters_per_epoch=max(iters_per_epoch, 1),
        **{k: v for k, v in (('lr', lr), ('accumulate_steps', accumulate),
                             ('max_epochs', epochs))
           if v is not None})
    return TrainConfig(model=model, optim=optim, eval=preset.eval,
                       batch_size=batch_size)


def load_official_checkpoint(path: str, model, say=print) -> None:
    """Warm-start the image backbone from an official Swin state dict (a
    ``.pth``, its tensors under 'model' or 'state_dict' or at the top)."""
    import torch

    from fusionocc_tpu_torch.weights import load_official_swin
    sd = torch.load(path, map_location='cpu', weights_only=True)
    for key in ('model', 'state_dict'):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    report = load_official_swin(
        model, {k: v.float().numpy() for k, v in sd.items()
                if hasattr(v, 'numpy')})
    say(f'load-from {path}: {len(report["loaded"])} backbone tensors '
        f'loaded, {len(report["missing"])} missing, '
        f'{len(report["unused"])} checkpoint keys unused', flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--ann-file', default=None)
    ap.add_argument('--data-root', default='')
    ap.add_argument('--img-seg-dir', default=None)
    ap.add_argument('--config', default=None,
                    help='named preset of fusionocc_tpu_torch.configs')
    ap.add_argument('--synthetic', action='store_true')
    ap.add_argument('--tiny', action='store_true', help='tiny model (debug)')
    ap.add_argument('--steps', type=int, default=0,
                    help='stop after N steps (0 = the whole schedule)')
    ap.add_argument('--batch-size', type=int, default=1)
    ap.add_argument('--epochs', type=int, default=None)
    ap.add_argument('--accumulate', type=int, default=None)
    ap.add_argument('--lr', type=float, default=None)
    ap.add_argument('--load-from', default=None,
                    help='official Swin checkpoint for the image backbone')
    ap.add_argument('--work-dir', default='./work_dirs/fusion_occ_torch')
    ap.add_argument('--resume', default=None)
    ap.add_argument('--ckpt-interval-steps', type=int, default=0,
                    help='0 = once per epoch')
    ap.add_argument('--log-interval', type=int, default=50)
    ap.add_argument('--render-interval', type=int, default=0,
                    help='log a BEV render of the EMA prediction every N '
                         'steps as a PNG (0 = off)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (each local rank's card), 'cuda:<i>' or "
                         "'cpu'")
    ap.add_argument('--coordinator', default=None,
                    help='host:port of rank 0 (without torchrun)')
    ap.add_argument('--num-processes', type=int, default=None)
    ap.add_argument('--process-id', type=int, default=None)
    args = ap.parse_args(argv)
    if not args.synthetic and not args.ann_file:
        ap.error('pass --ann-file (an infos pkl) or --synthetic')

    import torch

    from fusionocc_tpu_torch.parallel import mesh
    # before anything touches the card: each rank takes its own
    device = mesh.init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=None if args.device == 'cuda' else args.device)
    rank, world = mesh.rank(), mesh.world()
    try:
        train(args, device, rank, world)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def train(args, device, rank: int, world: int) -> None:
    import torch

    from fusionocc_tpu_torch.data.pipeline import to_device
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.parallel.mesh import shard_batch
    from fusionocc_tpu_torch.train import checkpoint as ckpt
    from fusionocc_tpu_torch.train.loop import (create_train_state,
                                                eval_step, train_step)
    from fusionocc_tpu_torch.utils.logging import MetricLogger

    on_card = device.type == 'cuda'
    say = print if rank == 0 else (lambda *a, **k: None)
    if args.synthetic:
        cfg = build_config(args.config, args.tiny, args.steps, args.lr,
                           args.accumulate, args.epochs, args.batch_size)
        from fusionocc_tpu_torch.data.synthetic import synthetic_batch
        batch = shard_batch(synthetic_batch(cfg.model, args.batch_size * world,
                                            0, device=device), rank, world)

        def batches():
            while True:
                yield batch
    else:
        from fusionocc_tpu_torch.data.dataset import (NuScenesOccDataset,
                                                      data_loader, prefetch)
        cfg = build_config(args.config, args.tiny, 1, args.lr,
                           args.accumulate, args.epochs, args.batch_size)
        ds = NuScenesOccDataset(args.ann_file, cfg.model,
                                data_root=args.data_root,
                                img_seg_dir=args.img_seg_dir, train=True,
                                seed=cfg.seed)
        per_epoch = max(len(ds) // (args.batch_size * world), 1)
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, iters_per_epoch=per_epoch))

        def batches():
            # every rank takes per_epoch batches of its shard per epoch, so
            # the ranks' steps (and collectives) stay paired
            epoch = 0
            while True:
                ds.set_epoch(epoch)     # fresh augmentations each epoch
                for host in itertools.islice(prefetch(data_loader(
                        ds, args.batch_size, shuffle=True, seed=epoch,
                        host_id=rank, host_count=world,
                        pin_memory=on_card)), per_epoch):
                    yield to_device(host, device)
                epoch += 1

    model = init_weights(FusionOcc(cfg.model, device=device),
                         torch.Generator().manual_seed(cfg.seed))
    if args.load_from:
        load_official_checkpoint(args.load_from, model, say)
    state = create_train_state(model, cfg)
    if args.resume:
        path = ckpt.latest_checkpoint(args.resume) or args.resume
        ckpt.restore_checkpoint(path, model, state)
        say(f'resumed from {path} at step {state.step}', flush=True)
    total = args.steps or cfg.optim.max_epochs * cfg.optim.iters_per_epoch
    ckpt_every = args.ckpt_interval_steps or cfg.optim.iters_per_epoch
    mlog = MetricLogger(args.work_dir) if rank == 0 else None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = batches()
    t0, first = time.perf_counter(), state.step
    while state.step < total:
        batch = next(gen)
        logs = train_step(model, cfg, state, batch)
        if state.step % args.log_interval == 0 or state.step == first + 1:
            sync()
            scalars = {k: float(v) for k, v in logs.items()}
            scalars['sec_per_iter'] = ((time.perf_counter() - t0)
                                       / (state.step - first))
            if mlog is not None:
                mlog.log(state.step, scalars)
            line = ' '.join(f'{k}={v:.4f}' for k, v in scalars.items())
            say(f'step {state.step}/{total} {line}', flush=True)
        if (mlog is not None and args.render_interval
                and state.step % args.render_interval == 0):
            from fusionocc_tpu_torch.utils.visualization import (
                occupancy_bev_image)
            pred = eval_step(model, state, batch, use_ema=True)
            mlog.log_image(state.step, 'train/bev_pred',
                           occupancy_bev_image(pred[0].cpu().numpy()))
        if state.step % ckpt_every == 0 and state.step < total:
            say(f'saved {ckpt.save_checkpoint(args.work_dir, model, state)}',
                flush=True)
    if mlog is not None:
        mlog.close()
    path = ckpt.save_checkpoint(args.work_dir, model, state)
    say(f'final checkpoint: {path}', flush=True)


if __name__ == '__main__':
    main()
