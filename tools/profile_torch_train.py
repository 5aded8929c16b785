"""Where one full-size training step of the PyTorch port spends its time on
the GPU.

    python3 tools/profile_torch_train.py [--iters 3] [--top 25]

Builds the default multi-modal configuration as ``chip_smoke.py`` phase 7
does (bf16 compute, fp32 parameters, seeded random weights, the synthetic
batch of seed 0), warms up with 2 ``train_step``s, then over ``--iters``
steps reports:

- ms per step and its forward / backward / optimizer split (CUDA events at
  ``train_step``'s marks), with the profiler off;
- the forward's device time in each of the program's spans
  (``utils/profiling.tracing``: the CUDA events of the camera, LiDAR and
  head spans, indented under their parents; both temporal frames enter the
  camera spans, the adjacent one without gradients);
- within the backward, the device time of the three kernel ``Function``s'
  backwards (``window_attention_bwd``, ``bev_pool_bwd``,
  ``zwin_conv_bwd``, wrapped in CUDA events; the Swin blocks' recompute
  under ``with_cp`` is not timed: the checkpoint stops it as soon as the
  saved tensors it needs are back);
- then, over as many steps under ``torch.profiler``, the kernels with the
  most device time and the summed kernel time per step, and the device idle
  share (1 - kernel time / unprofiled wall time).

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

from fusionocc_tpu_torch.config import (TrainConfig,  # noqa: E402
                                        full_model_config)
from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    FusionOcc, init_weights)
from fusionocc_tpu_torch.ops import (bev_pool, window_attn,  # noqa: E402
                                     zwin_conv)
from fusionocc_tpu_torch.train import loop  # noqa: E402
from fusionocc_tpu_torch.utils import profiling  # noqa: E402

# (module, backward function) of each kernel Function
BACKWARDS = ((window_attn, 'window_attention_bwd'),
             (bev_pool, 'bev_pool_bwd'), (zwin_conv, 'zwin_conv_bwd'))


def backward_timer():
    """CUDA events around each kernel Function's backward."""
    events = collections.defaultdict(list)
    originals = [(m, name, getattr(m, name)) for m, name in BACKWARDS]

    def timed(name, fn):
        def call(*args, **kwargs):
            pair = [torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True)]
            pair[0].record()
            out = fn(*args, **kwargs)
            pair[1].record()
            events[name].append(pair)
            return out
        return call
    for m, name, fn in originals:
        setattr(m, name, timed(name, fn))
    def remove():
        for m, name, fn in originals:
            setattr(m, name, fn)
    return events, remove


def span_rows(records):
    """(name indented by its depth, calls, summed device ms) of each span
    name, in the order the names first opened."""
    by_id = {s['id']: s for s in records['spans']}
    rows = {}
    for s in sorted(records['spans'], key=lambda s: s['start_ns']):
        depth, p = 0, s['parent']
        while p in by_id:
            depth, p = depth + 1, by_id[p]['parent']
        row = rows.setdefault(s['name'], ['  ' * depth + s['name'], 0, 0.0])
        row[1] += 1
        row[2] += s['device_ms']
    return list(rows.values())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--top', type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_train: needs a CUDA GPU')
    dev = 'cuda:0'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')
    cfg = full_model_config()
    tc = TrainConfig(model=cfg)
    model = init_weights(FusionOcc(cfg, device=dev),
                         torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, tc)
    batch = synthetic_batch(cfg, 1, 0, device=dev)
    for _ in range(2):
        loop.train_step(model, tc, state, batch)
    torch.cuda.synchronize()

    bwd_events, remove_bwd = backward_timer()
    parts = collections.defaultdict(list)

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        parts[part].append(ev)
    t0 = time.perf_counter()
    with profiling.tracing() as tr:
        for _ in range(args.iters):
            mark('start')
            loop.train_step(model, tc, state, batch, mark)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    remove_bwd()
    print(f'ms per train step (tracing on, profiler off): {wall_ms:.2f}')
    for a, b in (('start', 'forward'), ('forward', 'backward'),
                 ('backward', 'optimizer')):
        ms = sum(x.elapsed_time(y) for x, y in zip(parts[a], parts[b]))
        print(f'  {b:10s} {ms / args.iters:9.3f} ms')
    print('forward device ms by span (calls per step):')
    for name, calls, ms in span_rows(tr.collect()):
        print(f'  {name:42s} {ms / args.iters:9.3f}  '
              f'({calls // args.iters})')
    print('within the backward (calls per step):')
    for name in bwd_events:
        ms = sum(x.elapsed_time(y) for x, y in bwd_events[name])
        print(f'  {name:42s} {ms / args.iters:9.3f}  '
              f'({len(bwd_events[name]) // args.iters})')

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(args.iters):
            loop.train_step(model, tc, state, batch)
        torch.cuda.synchronize()
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / args.iters
    print(f'kernel time per train step (profiled) {kernel_ms:.2f} ms; '
          f'device idle share {1 - kernel_ms / wall_ms:.3f}')
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=args.top,
                                    max_name_column_width=60))


if __name__ == '__main__':
    main()
