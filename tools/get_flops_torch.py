"""Model cost analysis: parameters, FLOPs and memory, the PyTorch port's
counterpart of ``tools/get_flops.py`` (same flags, same sections, plus
``--device``).

The parameters by top-level module (``utils/profiling.param_memory_report``),
then the FLOPs of one two-pass ``predict`` (or, with ``--train``, of one
``train_step``: forward, backward and optimizer) on a synthetic batch,
counted by ``torch.utils.flop_counter`` with the four kernels' formulas
(``utils/flops.py``): the total with the kernels, the total without them
(the figure comparable to XLA's cost analysis, which cannot see inside a
``pallas_call``) and each kernel's share.  In place of XLA's memory
analysis, on the card: the bytes held before the call (parameters, inputs
and whatever else the process holds), the bytes of the call's output and
``max_memory_allocated`` above what was held.  Runs on the card unless
``--device`` names another.

``--config`` names a preset (its model through ``configs.build_model``);
BEVStereo4D-Occ's plane sweep counts by its frozen formula
(``utils/flops.py``), and the model has no training step here.

Usage:
  python3 tools/get_flops_torch.py [--config fusion_occ] [--tiny] [--train]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def output_bytes(out) -> int:
    """Bytes of every tensor in ``out`` (a tensor, or a tuple, list or dict
    of them)."""
    import torch
    if torch.is_tensor(out):
        return out.numel() * out.element_size()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return sum(output_bytes(o) for o in out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default=None,
                    help='preset of fusionocc_tpu_torch.configs (default: '
                    'the full FusionOcc)')
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--train', action='store_true',
                    help='analyze the training step instead of inference')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    import torch

    from fusionocc_tpu_torch import configs
    from fusionocc_tpu_torch.config import TrainConfig, full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.train.loop import create_train_state, train_step
    from fusionocc_tpu_torch.utils.flops import count_flops
    from fusionocc_tpu_torch.utils.profiling import param_memory_report
    from tools.test_torch import tiny_config

    cfg = (configs.get_config(args.config).model if args.config
           else full_model_config())
    if args.tiny:       # the tiny model, with or without the preset's LiDAR
        tiny = tiny_config()
        cfg = dataclasses.replace(
            tiny, use_lidar=cfg.use_lidar,
            lidar_out_channels=cfg.lidar_out_channels
            and tiny.lidar_out_channels)
    model = init_weights(configs.build_model(args.config, args.device, cfg),
                         torch.Generator().manual_seed(0))
    if args.train and type(model) is not FusionOcc:
        ap.error(f'--train: {type(model).__name__} has no training step '
                 'in the port')
    batch = synthetic_batch(cfg, 1, 0, num_points=512 if args.tiny else None,
                            device=args.device, frames=model.input_frames)

    print('--- parameters ---')
    for k, v in param_memory_report(model).items():
        if k.startswith('total'):
            print(f'{k}: {v:,.1f}' if isinstance(v, float) else f'{k}: {v:,}')
        else:
            print(f'{k}: {v / 1e6:.2f} M')

    tc = TrainConfig(model=cfg)
    mode = 'train' if args.train else 'predict'
    flops = count_flops(model, batch, mode, tc)
    what = 'train_step' if args.train else 'two-pass predict'
    print(f'--- FLOPs of one {what} (torch.utils.flop_counter, the kernels '
          'by their formulas) ---')
    print(f'flops: {flops["total"] / 1e9:.2f} GFLOP')
    print(f'flops without the kernels: {flops["outside"] / 1e9:.2f} GFLOP '
          "(XLA's cost analysis sees none inside a pallas_call)")
    for name, n in flops['kernels'].items():
        print(f'  {name}: {n / 1e9:.4f} GFLOP '
              f'({n / max(flops["total"], 1):.2%} of the total)')
    print("bytes accessed: XLA's cost analysis reads it from the compiled "
          'program; PyTorch has no counterpart, so none is printed')

    print('--- memory ---')
    if torch.device(args.device).type != 'cuda':
        print(f'not measured on {args.device}: max_memory_allocated needs '
              'the card')
        return
    if args.train:
        state = create_train_state(model, tc)

        def run():
            return train_step(model, tc, state, batch)
    else:
        def run():
            return model.predict(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    held_what = ('parameters, optimizer state, inputs' if args.train
                 else 'parameters, inputs')
    print(f'held before the call ({held_what}): {held / 2 ** 20:.1f} MiB')
    print(f'output: {output_bytes(out) / 2 ** 20:.1f} MiB')
    print(f'peak above what was held (max_memory_allocated): '
          f'{(peak - held) / 2 ** 20:.1f} MiB')


if __name__ == '__main__':
    main()
