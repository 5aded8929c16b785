"""GPU smoke run of the PyTorch port (``fusionocc_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card (nvidia-smi name and power limit), CUDA and nvcc
   versions, TF32 switched off for matmuls and cuDNN.
2. build: compiles ``fusionocc_tpu_torch/csrc/*.cu`` with nvcc (timed).
3. kernels: each kernel against its plain PyTorch version at the shapes the
   full-size main path gives it (window attention at the four Swin-B stage
   shapes, shift 0 and 6, bf16; frustum pooling on the full-size pooling
   index of the synthetic rig, fp32), with errors, tolerances and times.
4. reference: the midsize config in fp32 on the card (kernels) against the
   same weights on the CPU (plain versions).
5. slice: the full-size image-only model in bf16 with seeded random weights;
   per-frame pooling indices built once; ``predict`` on three synthetic
   batches (seeds 0-2).  Checks the output, the launch counts per predict,
   and prints ms per predict and peak memory.

The last two lines are the kernels' JSON summary and the result JSON.
Needs a CUDA GPU; on a machine without one it exits 1 before doing anything.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

DEV = 'cuda:0'
WA_TOL = dict(atol=1e-3, rtol=1e-2)    # bf16 output: one bf16 ulp is 2^-7 relative
POOL_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order
REF_TOL = dict(atol=2e-3, rtol=2e-3)   # fp32 model, GPU vs CPU
SLICE_SEEDS = (0, 1, 2)


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def check_close(name, got, want, atol, rtol):
    """Max abs / rel error of got vs want; fail beyond atol + rtol*|want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-6)).max().item()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    print(f'  {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} '
          f'(tol atol {atol:g} + rtol {rtol:g}*|plain|) '
          f'{"ok" if ok else "FAILED"}', flush=True)
    if not ok:
        fail(f'{name} disagrees with its plain version')
    return max_abs


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over reps calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a CUDA GPU', file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ''
    print('[1/5] device: nvidia-smi name, power.limit:')
    print(card)
    from fusionocc_tpu_torch.ops.kernels import find_nvcc
    nvcc = subprocess.run([find_nvcc(), '--version'], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'  torch {torch.__version__}, torch.version.cuda '
          f'{torch.version.cuda}, nvcc: {nvcc[-1] if nvcc else "?"}')
    print(f'  device 0: {torch.cuda.get_device_name(0)}, count '
          f'{torch.cuda.device_count()}; allow_tf32: matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}; cudnn.benchmark '
          f'{torch.backends.cudnn.benchmark}', flush=True)
    return card


def phase_build() -> None:
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    t0 = time.perf_counter()
    path = KERNELS.build()
    KERNELS.load()
    took = time.perf_counter() - t0
    how = ('compiled' if KERNELS.build_seconds is not None
           else 'found built')
    print(f'[2/5] build: {how} {path.name} in {took:.1f} s')
    for line in KERNELS.build_log.splitlines():
        if 'Used' in line or 'Compiling entry' in line:
            print('  ptxas' + line.split('ptxas', 1)[-1])
    sys.stdout.flush()


def stage_shapes(cfg):
    """(nWh, nWw, C, heads) of each Swin stage for one camera pass."""
    sw = cfg.swin
    w = sw.window_size
    h, wd = cfg.input_size[0] // sw.patch_size, cfg.input_size[1] // sw.patch_size
    out = []
    for i, c in enumerate(sw.num_features):
        out.append((-(-h // w), -(-wd // w), c, sw.num_heads[i]))
        h, wd = -(-h // 2), -(-wd // 2)
    return out


def phase_kernels(cfg, batch0) -> dict:
    from fusionocc_tpu_torch.models.fusion_occ import frame_pooling_index
    from fusionocc_tpu_torch.ops import bev_pool as bp
    from fusionocc_tpu_torch.ops import window_attn as wa
    print('[3/5] kernels vs plain versions at main-path shapes')
    g = torch.Generator(device=DEV).manual_seed(1234)
    w = cfg.swin.window_size
    n = w * w
    wa_err, wa_ms, wa_plain_ms = 0.0, 0.0, 0.0
    for nWh, nWw, c, heads in stage_shapes(cfg):
        bn = cfg.num_cams * nWh * nWw
        qkv = torch.randn(bn, n, 3 * c, device=DEV, generator=g
                          ).to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        bias = torch.randn(heads, n, n, device=DEV, generator=g)
        for shift in (0, w // 2):
            args = (q, k, v, bias, nWh, nWw, w, shift, heads)
            got = wa.window_attention_cuda(*args)
            want = wa.window_attention_plain(*args)
            torch.cuda.synchronize()
            name = (f'window_attn Bn={bn} C={c} heads={heads} '
                    f'grid={nWh}x{nWw} shift={shift}')
            wa_err = max(wa_err, check_close(name, got, want, **WA_TOL))
            t_k = cuda_ms(lambda: wa.window_attention_cuda(*args))
            t_p = cuda_ms(lambda: wa.window_attention_plain(*args))
            wa_ms += t_k
            wa_plain_ms += t_p
            print(f'    kernel {t_k:.4f} ms, plain {t_p:.4f} ms', flush=True)

    idx = frame_pooling_index(cfg, batch0.sensor2keyego[:, 0],
                              batch0.intrins[:, 0], batch0.post_rots[:, 0],
                              batch0.post_trans[:, 0], batch0.bda)
    B, N, D = 1, cfg.num_cams, cfg.grid.num_depth_bins
    h, wf = cfg.feat_size
    C = cfg.vt.feature_channels
    gx, gy, gz = cfg.grid.grid_size
    nvox = B * gz * gy * gx
    depth = torch.softmax(torch.randn(B, N, D, h, wf, device=DEV, generator=g),
                          dim=2).reshape(-1)
    feat = torch.randn(B * N * h * wf, C, device=DEV, generator=g)
    got = bp.bev_pool_cuda(depth, feat, idx, nvox)
    want = bp.bev_pool_plain(depth, feat, idx, nvox)
    torch.cuda.synchronize()
    n_in = int(idx.bounds[-1])
    pool_err = check_close(
        f'bev_pool P={idx.ranks_depth.numel()} in-grid={n_in} C={C} '
        f'voxels={nvox}', got, want, **POOL_TOL)
    t_k = cuda_ms(lambda: bp.bev_pool_cuda(depth, feat, idx, nvox))
    t_p = cuda_ms(lambda: bp.bev_pool_plain(depth, feat, idx, nvox))
    print(f'    kernel {t_k:.4f} ms, plain {t_p:.4f} ms', flush=True)
    print(f'  window_attn summed over the 8 shapes: kernel {wa_ms:.4f} ms, '
          f'plain {wa_plain_ms:.4f} ms', flush=True)
    return {'window_attn_fwd': (wa_err, wa_ms, wa_plain_ms),
            'bev_pool_fwd': (pool_err, t_k, t_p)}


def phase_reference() -> None:
    """Midsize fp32: the card (kernels) against the CPU (plain versions)."""
    from fusionocc_tpu_torch.config import midsize_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    print('[4/5] reference: midsize fp32, card vs CPU plain versions')
    cfg = midsize_model_config(use_lidar=False)
    model = init_weights(FusionOcc(cfg), torch.Generator().manual_seed(7))
    with torch.inference_mode():
        want = model(synthetic_batch(cfg, 1, 0, num_points=96))
    model.to(DEV)
    with torch.inference_mode():
        got = model(synthetic_batch(cfg, 1, 0, num_points=96, device=DEV))
    torch.cuda.synchronize()
    for key in ('occ_logits', 'depth', 'seg_logits'):
        check_close(f'midsize {key}', got[key].cpu(), want[key], **REF_TOL)
    agree = (got['occ_logits'].argmax(-1).cpu()
             == want['occ_logits'].argmax(-1)).float().mean().item()
    print(f'  midsize argmax agreement {agree:.6f} (need >= 0.999)', flush=True)
    if agree < 0.999:
        fail('midsize argmax agreement below 0.999')


def phase_slice(cfg, batches) -> dict:
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, init_weights)
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    print('[5/5] slice: full-size image-only predict, bf16')
    t0 = time.perf_counter()
    model = init_weights(FusionOcc(cfg), torch.Generator().manual_seed(0))
    model.to(DEV)
    pool_idxs = batch_pooling_indices(cfg, batches[0])
    torch.cuda.synchronize()
    print(f'  model + pooling indices ready in {time.perf_counter() - t0:.1f} s'
          f' ({sum(p.numel() for p in model.parameters())} parameters)')
    with torch.inference_mode():
        out = model(batches[0], pool_idxs)          # warm-up, checks logits
    torch.cuda.synchronize()
    logits = out['occ_logits']
    gx, gy, gz = cfg.grid.grid_size
    if logits.shape != (1, gx, gy, gz, cfg.num_classes):
        fail(f'occ_logits shape {tuple(logits.shape)}')
    if not bool(torch.isfinite(logits).all()):
        fail('occ_logits not finite')
    print(f'  warm-up forward: occ_logits {tuple(logits.shape)} finite, '
          f'depth {tuple(out["depth"].shape)}, seg {tuple(out["seg_logits"].shape)}')

    # one window-attention launch per Swin block, one pooling per frame
    expect = {'window_attn_fwd': sum(cfg.swin.depths) * cfg.num_frame,
              'bev_pool_fwd': cfg.num_frame}
    torch.cuda.reset_peak_memory_stats()
    KERNELS.reset_counts()
    times = []
    for batch in batches:
        before = dict(KERNELS.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = model.predict(batch, pool_idxs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        delta = {k: KERNELS.launches[k] - before[k] for k in before}
        if pred.shape != (1, gx, gy, gz) or pred.dtype != torch.uint8:
            fail(f'predict gave {tuple(pred.shape)} {pred.dtype}')
        if delta != expect:
            fail(f'launches per predict {delta}, expected {expect}')
    totals = dict(KERNELS.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f'  predict x{len(batches)}: output (1, {gx}, {gy}, {gz}) uint8; '
          f'launches per predict {expect}, total {totals}')
    print(f'  ms per frame (one predict: {cfg.num_frame} camera passes + '
          f'head): median {statistics.median(times):.1f}, all '
          f'{[round(t, 1) for t in times]}; peak memory '
          f'{peak / 2**30:.2f} GiB', flush=True)
    return totals


def main() -> None:
    card = phase_device()
    phase_build()
    from fusionocc_tpu_torch.config import image_only_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    cfg = image_only_model_config()
    t0 = time.perf_counter()
    batches = [synthetic_batch(cfg, 1, s, device=DEV) for s in SLICE_SEEDS]
    print(f'  synthetic batches (seeds {SLICE_SEEDS}) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    measured = phase_kernels(cfg, batches[0])
    phase_reference()
    launches = phase_slice(cfg, batches)
    sources = {
        'window_attn_fwd': ('fusionocc_tpu_torch/csrc/window_attn.cu',
                            'fusionocc_tpu/ops/pallas/window_attn.py:79'),
        'bev_pool_fwd': ('fusionocc_tpu_torch/csrc/bev_pool.cu',
                         'fusionocc_tpu/ops/pallas/segsum.py:31'),
    }
    kernels = []
    for name, (err, ms, plain_ms) in measured.items():
        if launches[name] == 0:
            fail(f'{name} was not launched by the main path')
        kernels.append({'name': name, 'route': 'cuda',
                        'source': sources[name][0],
                        'replaces': sources[name][1],
                        'launches': launches[name], 'max_abs_err': err,
                        'ms': ms, 'plain_ms': plain_ms})
    print(f'card: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
