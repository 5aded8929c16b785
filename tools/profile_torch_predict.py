"""Where one full-size ``predict`` of the PyTorch port, or one
``predict_streaming`` frame, in the default multi-modal configuration,
spends its time on the GPU.

    python3 tools/profile_torch_predict.py [--iters 3] [--top 25] [--streaming]
        [--zwin-fuse] [--int8]

Builds the model as ``chip_smoke.py`` does (bf16, seeded random weights,
synthetic batch, cached pooling indices), warms up, then over ``--iters``
steps reports, where a step is one two-pass ``predict`` or, with
``--streaming``, one ``predict_streaming`` frame on the cache the step
before left (the same frame each step: the warp costs the same whatever
the motion):

- ms per step and the device time of each top-level submodule (the
  LiDAR encoder included) and of the view transformer's parts, from CUDA
  events recorded by forward hooks (each camera pass enters the camera
  modules once: two per predict, one per streaming frame), with the
  profiler off;
- the LiDAR encoder's steps the same way: its functions (voxelization,
  regroup, index builds, the zwin convs, the dense tail) wrapped in CUDA
  events for the run, and its masked BatchNorms hooked; with
  ``--streaming`` also the cache warp (``_shift_bev``); with
  ``--zwin-fuse`` the encoder runs K3 with its fused epilogue
  (``zwin_conv_epi``: the sparse stages' BatchNorms and ReLUs are in it,
  so only the dense tail's two BatchNorms are hooked); with ``--int8``
  Swin-B's Linears take int8 products (``swin.int8_dense``);
- then, over as many steps under ``torch.profiler``, the kernels with the
  most device time and the summed kernel time per step;
- the device idle share: 1 - kernel time / unprofiled wall time.

Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fusionocc_tpu_torch.config import full_model_config  # noqa: E402
from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models import lidar_encoder  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    FusionOcc, batch_pooling_indices, init_weights)
from fusionocc_tpu_torch.nn.layers import MaskedBatchNorm  # noqa: E402

MODULES = ('img_backbone', 'img_neck', 'img_view_transformer',
           'img_view_transformer.img_reduce_conv',
           'img_view_transformer.depth_encoder',
           'img_view_transformer.cross_model_fusion',
           'img_view_transformer.further_fuse',
           'img_view_transformer.depth_seg_net',
           'pre_process_net', 'lidar_encoder', 'img_bev_encoder_backbone',
           'img_bev_encoder_neck', 'final_conv')
# functions the LiDAR encoder calls, by their names in its module
ENCODER_STEPS = ('voxelize_mean', 'sparse_conv1x1_apply', 'zfold_regroup',
                 'stage_indices_table', 'strided_lane_mask', 'zwin_conv',
                 'zwin_conv_epi', 'dense_from_zfold', 'strided_out_mask',
                 'dense_conv3d')


def _record(events, name):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events[name].append([ev, None])


def _close(events, name):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events[name][-1][1] = ev


def module_timer(model):
    """Forward hooks recording CUDA events around each of MODULES."""
    events = collections.defaultdict(list)
    handles = []

    def pre(name):
        return lambda mod, args: _record(events, name)

    def post(name):
        return lambda mod, args, out: _close(events, name)

    mods = [(name, model.get_submodule(name)) for name in MODULES]
    mods += [('  MaskedBatchNorm', m) for m in model.lidar_encoder.modules()
             if isinstance(m, MaskedBatchNorm)]
    for name, mod in mods:
        handles.append(mod.register_forward_pre_hook(pre(name)))
        handles.append(mod.register_forward_hook(post(name)))
    originals = {name: getattr(lidar_encoder, name) for name in ENCODER_STEPS}

    def timed(name, fn):
        def call(*args, **kwargs):
            _record(events, name)
            out = fn(*args, **kwargs)
            _close(events, name)
            return out
        return call
    for name, fn in originals.items():
        setattr(lidar_encoder, name, timed(f'  {name}', fn))
    # the streaming cache's warp, a method of the model
    model._shift_bev = timed('_shift_bev (cache warp)', model._shift_bev)

    def remove():
        for h in handles:
            h.remove()
        for name, fn in originals.items():
            setattr(lidar_encoder, name, fn)
        del model._shift_bev
    return events, remove


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--top', type=int, default=25)
    ap.add_argument('--streaming', action='store_true',
                    help='profile predict_streaming frames, not predict')
    ap.add_argument('--zwin-fuse', action='store_true',
                    help="the LiDAR encoder with K3's fused epilogue "
                    '(zwin_fuse=True)')
    ap.add_argument('--int8', action='store_true',
                    help="Swin-B's Linears through int8 products "
                    '(swin.int8_dense=True)')
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

    cfg = full_model_config()
    if args.zwin_fuse:
        cfg = dataclasses.replace(cfg, lidar=dataclasses.replace(
            cfg.lidar, zwin_fuse=True))
    if args.int8:
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(
            cfg.swin, int8_dense=True))
    print(f'zwin_fuse={cfg.lidar.zwin_fuse} int8_dense={cfg.swin.int8_dense}')
    model = init_weights(FusionOcc(cfg, device=dev),
                         torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 1, 0, device=dev)
    idxs = batch_pooling_indices(cfg, batch)
    state = model.init_streaming_state(1)

    def step():
        nonlocal state
        if args.streaming:
            _, _, state = model.predict_streaming(batch, state, idxs[0])
        else:
            model.predict(batch, idxs)
    what = 'streaming frame' if args.streaming else 'predict'
    for _ in range(2):
        step()
    torch.cuda.synchronize()

    events, remove = module_timer(model)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    remove()
    print(f'ms per {what} (hooks on, profiler off): {wall_ms:.2f}')
    print(f'device ms per {what} by module (calls per {what}); the LiDAR '
          "encoder's steps indented below it:")
    for name in events:
        ms = sum(a.elapsed_time(b) for a, b in events[name])
        print(f'  {name:42s} {ms / args.iters:9.3f}  '
              f'({len(events[name]) // args.iters})')

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / args.iters
    print(f'kernel time per {what} (profiled) {kernel_ms:.2f} ms; device '
          f'idle share {1 - kernel_ms / wall_ms:.3f}')
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=args.top,
                                    max_name_column_width=60))


if __name__ == '__main__':
    main()
