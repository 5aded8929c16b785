"""Time the port's window attention (K2) and zwin conv (K3) kernels from a
given source tree.

    python3 tools/ab_torch_kernels.py [--root DIR] [--label X] [--reps 20]

Imports ``fusionocc_tpu_torch`` (and that tree's ``chip_smoke.py`` and
``tools/profile_torch_zwin_micro.py``) from ``--root`` (default: this
checkout), so one call can time two trees in turn, as
``tools/ab_torch_predict.py`` does for the predict.  On the card it times,
with ``chip_smoke.cuda_ms`` (CUDA events, mean over ``--reps`` calls):

- K2 (``window_attention_cuda``, bf16) at the 8 shapes of the full-size
  predict (``chip_smoke.stage_shapes``: the 4 Swin-B stages of one camera
  pass of 6 images, N = 144, shift 0 and 6), inputs from a seeded
  generator, and the launch-weighted ms per two-pass predict (each shape
  runs once per block of its shift in each of the two camera passes: 2, 2,
  18 and 2 times), and the wrapper's host time per launch (the tensor
  maps' host work included): the mean of 50 launches queued behind a
  sleeping card;
- K3 (``zwin_conv_cuda``, bf16) at the 9 launches of the full-size LiDAR
  encoder (seeded random weights, the synthetic cloud of seed 0), K3 with
  its fused epilogue (``zwin_conv_epi_cuda``) at the same 9 launches, and
  the null body (``zwin_conv_null_cuda``) at stage 1's SubM launch.

Prints one JSON line: the label, the root, the card's ``nvidia-smi`` name
and power limit, and the times.  Needs a CUDA GPU; without one it exits
non-zero before importing the port.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--label', default='')
    ap.add_argument('--reps', type=int, default=20)
    return ap.parse_args(argv)


def host_us(fn, n: int = 50) -> float:
    """Mean host time of fn() in microseconds, the card kept busy."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)        # about 100 ms: the queue never blocks
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / n * 1e6


def time_k2(cs, cfg, reps: int) -> dict:
    import torch
    from fusionocc_tpu_torch.ops import window_attn as wa
    g = torch.Generator(device='cuda').manual_seed(1234)
    w = cfg.swin.window_size
    n = w * w
    # launches of a stage's shape (one shift) per two-pass predict: two
    # camera passes whose blocks alternate shift 0 and w // 2
    per_shape = cfg.swin.depths
    shapes, total, per_predict = [], 0., 0.
    host = None
    for i, (nWh, nWw, c, heads) in enumerate(cs.stage_shapes(cfg)):
        bn = cfg.num_cams * nWh * nWw
        qkv = torch.randn(bn, n, 3 * c, device='cuda', generator=g
                          ).to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        bias = torch.randn(heads, n, n, device='cuda', generator=g)
        for shift in (0, w // 2):
            args = (q, k, v, bias, nWh, nWw, w, shift, heads)
            ms = cs.cuda_ms(lambda: wa.window_attention_cuda(*args), reps=reps)
            row = dict(bn=bn, c=c, heads=heads, shift=shift, ms=ms)
            total += ms
            per_predict += ms * per_shape[i]
            if i == 2 and shift:
                host = host_us(lambda: wa.window_attention_cuda(*args))
            shapes.append(row)
    return dict(shapes=shapes, total_ms=total, per_predict_ms=per_predict,
                host_us_per_launch=host)


def time_k3(cs, cfg, reps: int) -> dict:
    import torch
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    from tools import profile_torch_zwin_micro as micro
    batch = synthetic_batch(cfg, 1, 0, device='cuda')
    with torch.inference_mode():
        calls = micro.record_zwin_launches(cfg, batch, 'cuda')
        launches, total = [], 0.
        for args in calls:
            ms = cs.cuda_ms(lambda: zw.zwin_conv_cuda(*args), reps=reps)
            total += ms
            launches.append(dict(cin=args[3].shape[1], cout=args[3].shape[2],
                                 stride=args[6], rows_in=args[0].shape[1],
                                 rows_out=args[2].shape[1], ms=ms))
        stage1 = micro.stage1_subm(calls)
        null = cs.cuda_ms(lambda: zw.zwin_conv_null_cuda(*stage1), reps=reps)
        fused = [args for args, _ in cs.fused_launches(cfg, batch)]
        epi = sum(cs.cuda_ms(lambda: zw.zwin_conv_epi_cuda(*args), reps=reps)
                  for args in fused)
    return dict(launches=launches, total_ms=total, epi_total_ms=epi,
                null_stage1_subm_ms=null)


def main(argv=None) -> None:
    opts = parse(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit('ab_torch_kernels: needs a CUDA GPU')
    sys.path.insert(0, os.path.abspath(opts.root))
    import chip_smoke as cs
    from fusionocc_tpu_torch.config import full_model_config
    cfg = full_model_config()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({'label': opts.label, 'root': os.path.abspath(opts.root),
                      'card': card, 'reps': opts.reps,
                      'k2': time_k2(cs, cfg, opts.reps),
                      'k3': time_k3(cs, cfg, opts.reps)}), flush=True)


if __name__ == '__main__':
    main()
