"""Where one full-size image-only ``predict`` of the PyTorch port spends its
time on the GPU.

    python3 tools/profile_torch_predict.py [--iters 3] [--top 25]

Builds the model as ``chip_smoke.py`` does (bf16, seeded random weights,
synthetic batch, cached pooling indices), warms up, then over ``--iters``
predicts reports:

- ms per predict and the device time of each top-level submodule and of
  the view transformer's parts, from CUDA events recorded by forward hooks
  (each of the two camera passes enters the camera modules once), with the
  profiler off;
- then, over as many predicts under ``torch.profiler``, the kernels with the
  most device time and the summed kernel time per predict;
- the device idle share: 1 - kernel time / unprofiled wall time.

Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fusionocc_tpu_torch.config import image_only_model_config  # noqa: E402
from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    FusionOcc, batch_pooling_indices, init_weights)

MODULES = ('img_backbone', 'img_neck', 'img_view_transformer',
           'img_view_transformer.img_reduce_conv',
           'img_view_transformer.depth_encoder',
           'img_view_transformer.cross_model_fusion',
           'img_view_transformer.further_fuse',
           'img_view_transformer.depth_seg_net',
           'pre_process_net', 'img_bev_encoder_backbone',
           'img_bev_encoder_neck', 'final_conv')


def module_timer(model):
    """Forward hooks recording CUDA events around each of MODULES."""
    events = collections.defaultdict(list)
    handles = []

    def pre(name):
        def hook(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])
        return hook

    def post(name):
        def hook(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev
        return hook

    for name in MODULES:
        mod = model.get_submodule(name)
        handles.append(mod.register_forward_pre_hook(pre(name)))
        handles.append(mod.register_forward_hook(post(name)))
    return events, handles


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--top', type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_predict: needs a CUDA GPU')
    dev = 'cuda:0'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')

    cfg = image_only_model_config()
    model = init_weights(FusionOcc(cfg), torch.Generator().manual_seed(0))
    model.to(dev)
    batch = synthetic_batch(cfg, 1, 0, device=dev)
    idxs = batch_pooling_indices(cfg, batch)
    for _ in range(2):
        model.predict(batch, idxs)
    torch.cuda.synchronize()

    events, handles = module_timer(model)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        model.predict(batch, idxs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    for h in handles:
        h.remove()
    print(f'ms per predict (hooks on, profiler off): {wall_ms:.2f}')
    print('device ms per predict by module (calls per predict):')
    for name in MODULES:
        ms = sum(a.elapsed_time(b) for a, b in events[name])
        print(f'  {name:42s} {ms / args.iters:9.3f}  '
              f'({len(events[name]) // args.iters})')

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(args.iters):
            model.predict(batch, idxs)
        torch.cuda.synchronize()
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / args.iters
    print(f'kernel time per predict (profiled) {kernel_ms:.2f} ms; device '
          f'idle share {1 - kernel_ms / wall_ms:.3f}')
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=args.top,
                                    max_name_column_width=60))


if __name__ == '__main__':
    main()
