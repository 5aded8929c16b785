"""Where one full-size ``predict`` of the PyTorch port, or one
``predict_streaming`` frame, of a preset (the default multi-modal
``fusion_occ`` unless ``--config`` names another, say
``bevdet_occ_stbase_stereo`` or ``bevformer_base_occ``) spends its time on
the GPU, by the program's own spans and waits.

    python3 tools/profile_torch_predict.py [--config fusion_occ] [--iters 3]
        [--top 25] [--streaming] [--zwin-fuse] [--int8]
        [--out-dir work_dirs/profile_torch_predict]

Builds the preset's model (``configs.build_model``) as ``chip_smoke.py``
does (bf16, seeded random weights, a synthetic batch of the model's
``input_frames``), warms up, then reports, where a step is one two-pass
``predict`` with the key frame's pooling index cached and the adjacent
frame's built in the call (the evaluation's semantics) or, with
``--streaming``, one ``predict_streaming`` frame with the key index cached,
on the cache the step before left (the same frame each step: the warp
costs the same whatever the motion).  BEVFormer-Occ caches its rig's
spatial cross-attention index (``rig_index``) in the pooling index's
place, and its streamed step carries the previous BEV:

- ms per step with the port's tracing off and on, alternated, without a
  profiler;
- over ``--iters`` steps with the port's tracing on
  (``utils/profiling.tracing``), per step: per span its calls, device ms
  (its CUDA events), host ms, its waits and their host ms, without a
  profiler; the device's idle inside it (children included) and its own,
  under ``torch.profiler`` (CUDA activity alone, the same steps again);
  the wait sites; the idle no span covers; the clock check
  (``benchmark/harness/spans.py``'s ``record``, the benchmark's own; the
  trace with the spans merged in written to ``--out-dir``, for Perfetto);
- then, over as many steps under ``torch.profiler`` with the host's
  operations too, the kernels with the most device time.

With ``--zwin-fuse`` the encoder runs K3 with its fused epilogue
(``zwin_conv_epi``); with ``--int8`` Swin-B's Linears take int8 products
(``swin.int8_dense``).  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fusionocc_tpu_torch import configs  # noqa: E402
from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    batch_pooling_indices, init_weights)
from fusionocc_tpu_torch.utils import profiling  # noqa: E402


def step_ms(step, pairs: int):
    """Median ms of a synchronised step with the tracing off and on,
    alternated ``pairs`` times."""
    ms = {'off': [], 'on': []}
    for _ in range(pairs):
        for mode in ms:
            t0 = time.perf_counter()
            with profiling.tracing() if mode == 'on' else profiling.NOOP:
                step()
                torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in ms.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--config', default='fusion_occ',
                    help='preset of fusionocc_tpu_torch.configs')
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
    ap.add_argument('--out-dir', default='work_dirs/profile_torch_predict',
                    help='where the trace with the spans merged in goes')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_predict: needs a CUDA GPU')
    sys.path.insert(0, str(ROOT / 'benchmark'))
    from harness import spans
    dev = 'cuda:0'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True).stdout.strip()
    print(f'card: {card}')

    cfg = configs.get_config(args.config).model
    if args.zwin_fuse:
        cfg = dataclasses.replace(cfg, lidar=dataclasses.replace(
            cfg.lidar, zwin_fuse=True))
    if args.int8:
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(
            cfg.swin, int8_dense=True))
    print(f'config={args.config} zwin_fuse={cfg.lidar.zwin_fuse} '
          f'int8_dense={cfg.swin.int8_dense}')
    model = init_weights(configs.build_model(args.config, dev, cfg),
                         torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 1, 0, device=dev,
                            frames=model.input_frames)
    if hasattr(model, 'rig_index'):                 # BEVFormer-Occ
        key = idxs = model.rig_index(batch)
    else:
        idxs = batch_pooling_indices(cfg, batch)[:1]    # the key frame's
        idxs += [None] * (cfg.num_frame - 1)
        key = idxs[0]
    state = model.init_streaming_state(1) if args.streaming else None

    def step():
        nonlocal state
        if args.streaming:
            _, _, state = model.predict_streaming(batch, state, key)
        else:
            model.predict(batch, idxs)
    what = 'streaming frame' if args.streaming else 'predict'
    for _ in range(2):
        step()
    torch.cuda.synchronize()

    ms = step_ms(step, max(args.iters, 3))
    print(f'ms per {what} (no profiler): tracing off {ms["off"]:.2f}, '
          f'on {ms["on"]:.2f}')
    name = 'streaming' if args.streaming else 'predict'
    result = spans.record(lambda k: step(), args.iters, Path(args.out_dir),
                          name)
    print(f'per {what}, tracing on (idle: under the profiler, CUDA '
          f'activity); trace: {args.out_dir}/{name}.spans.trace.json')
    print(spans.table(result))

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=args.top,
                                    max_name_column_width=60))


if __name__ == '__main__':
    main()
