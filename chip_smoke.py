"""GPU smoke run of the PyTorch port (``fusionocc_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card (nvidia-smi name and power limit), CUDA and nvcc
   versions, TF32 switched off for matmuls and cuDNN.
2. build: compiles ``fusionocc_tpu_torch/csrc/*.cu`` with nvcc, one process
   per source, all started together (timed), prints ptxas's registers and
   spills, and counts the tensor-core instructions (``HMMA``/``HGMMA``) of
   every kernel body in the library with ``cuobjdump --dump-sass``: the bf16
   bodies of K2 and K3 must have some.
3. kernels: each kernel against its plain PyTorch version at the shapes the
   full-size main path gives it, with errors, tolerances, times and bounds:
   window attention (K2) at the four Swin-B stage shapes, shift 0 and 6,
   bf16 (tensor cores), beside ``scaled_dot_product_attention`` on the same
   inputs (each backend that takes them, the fastest reported as the library
   time); frustum pooling (K1) on the full-size pooling index of the
   synthetic rig, bf16 features to bf16 voxels (the main path) and fp32 to
   fp32, two launches bit-identical, beside ``embedding_bag`` on the same
   inputs and the kernel on an index with no in-grid point (the zero-fill
   alone); the zwin sparse conv (K3) at the 9 launches of the
   full-size LiDAR encoder, bf16 (tensor cores), with the inputs that the
   port's encoder (seeded random weights) gives it on the full-size
   synthetic cloud; then K3's microbenchmark
   (``tools/profile_torch_zwin_micro.py``) once at stage 1's SubM launch;
   then both bf16 bodies at small shapes the main path does not give them
   (K2 with N = 49 and 100, padded to 144; K3 with B = 2, Cout = 24,
   f_out = 4, Cin = 64, random maps with misses and mask holes).
4. reference: the midsize multi-modal config in fp32 on the card (the
   kernels' fp32 bodies) against the same weights on the CPU (plain
   versions).
5. slice: two full-size bf16 paths with seeded random weights, per-frame
   pooling indices built once, ``predict`` on three synthetic batches (seeds
   0-2): the image-only preset, then the default multi-modal config (the
   main path).  Each path checks its output and its launch counts per
   predict, and prints ms per predict and peak memory; the main path also
   prints the LiDAR encoder's own device time.

A kernel's bound is the least time the card could take for the same work:
the larger of its operations over the peak rate of their type and its bytes
(each input read once, each output written once) over the memory rate,
from NVIDIA's H100 SXM data sheet.

The last two lines are the kernels' JSON summary and the result JSON.
Needs a CUDA GPU; on a machine without one it exits 1 before doing anything.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import torch

DEV = 'cuda:0'
WA_TOL = dict(atol=1e-3, rtol=1e-2)    # bf16 output: one bf16 ulp is 2^-7 relative
POOL_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums taken in another order
POOL_BF16_TOL = dict(atol=1e-4, rtol=2 ** -7)  # the same, cast: one bf16 ulp
ZWIN_TOL = dict(atol=1e-3, rtol=1e-2)  # fp32 sums cast once to bf16: one ulp
REF_TOL = dict(atol=2e-3, rtol=2e-3)   # fp32 model, GPU vs CPU
SLICE_SEEDS = (0, 1, 2)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
PEAK_BYTES = 3.35e12
QUEUE_CYCLES = 20_000_000   # about 10 ms at the H100's SM clock
# the kernels of the main path; the launch checks read these counts only
MAIN_KERNELS = ('window_attn_fwd', 'bev_pool_fwd', 'zwin_conv_fwd')
# mangled-name part of each kernel body -> (C entry, body); the bodies that
# must use the tensor cores are marked True
KERNEL_BODIES = {
    'window_attn_mma_kernel': ('window_attn_fwd', 'bf16', True),
    'window_attn_fp32_kernel': ('window_attn_fwd', 'fp32', False),
    'zwin_conv_mma_kernelILb0E': ('zwin_conv_fwd', 'bf16', True),
    'zwin_conv_mma_kernelILb1E': ('zwin_conv_null', 'bf16, no products',
                                  False),
    'zwin_conv_fp32_kernel': ('zwin_conv_fwd', 'fp32', False),
    'bev_pool_fwd_kernelILb1ELb1E': ('bev_pool_fwd', 'bf16 feat, bf16 out',
                                     False),
    'bev_pool_fwd_kernelILb1ELb0E': ('bev_pool_fwd', 'bf16 feat, fp32 out',
                                     False),
    'bev_pool_fwd_kernelILb0ELb1E': ('bev_pool_fwd', 'fp32 feat, bf16 out',
                                     False),
    'bev_pool_fwd_kernelILb0ELb0E': ('bev_pool_fwd', 'fp32 feat, fp32 out',
                                     False),
}


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
    """Mean device time of fn() in ms, by CUDA events over reps calls.  The
    card first sleeps (QUEUE_CYCLES) while the host queues the calls, so a
    kernel shorter than its wrapper's host time is timed, not the host."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Bound:
    """Summed least time of a kernel's launches: per launch the larger of
    flops / peak and bytes / memory rate."""

    def __init__(self):
        self.ms = {'bytes': 0.0, 'operations': 0.0}

    def add(self, flops: float, nbytes: float, dtype) -> float:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        by = 'bytes' if t_bytes >= t_ops else 'operations'
        self.ms[by] += max(t_ops, t_bytes)
        print(f'    bound {max(t_ops, t_bytes):.4f} ms by {by} '
              f'({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)', flush=True)
        return max(t_ops, t_bytes)

    def total(self):
        return sum(self.ms.values()), max(self.ms, key=self.ms.get)


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


def sass_mma_counts(lib) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel function of the
    built library, from ``cuobjdump --dump-sass``."""
    from pathlib import Path
    from fusionocc_tpu_torch.ops.kernels import find_nvcc
    cuobjdump = Path(find_nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '--dump-sass', str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            counts[name] = 0
        elif name is not None and ('HMMA' in line or 'HGMMA' in line):
            counts[name] += 1
    return counts


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
        if 'Used' in line or 'Compiling entry' in line or 'spill' in line:
            print('  ptxas' + line.split('ptxas', 1)[-1])
    counts = sass_mma_counts(path)
    print('  tensor-core instructions (HMMA/HGMMA) per kernel body, '
          'cuobjdump --dump-sass:')
    for key, (entry, body, needs_mma) in KERNEL_BODIES.items():
        found = [n for n in counts if key in n]
        if not found:
            fail(f'kernel body {key} ({entry}) not in the library')
        mma = sum(counts[n] for n in found)
        print(f'    {entry} {body} ({key}): {mma}', flush=True)
        if needs_mma and mma == 0:
            fail(f'the {body} body of {entry} has no tensor-core instruction')
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


def sdpa_times(q, k, v, bias, nWh, nWw, w, shift, heads, want):
    """``scaled_dot_product_attention`` on K2's inputs, timed only: per
    backend that takes them, ms and max abs diff to the plain version.

    The additive mask (bias, plus the shift mask) is in q's dtype, as SDPA
    takes it, and broadcast, never copied per window: shift 0 gives every window
    the (heads, N, N) bias; a shifted layer views each camera's windows as
    nW*heads heads of one batch entry against one (nW*heads, N, N) mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from fusionocc_tpu_torch.ops import window_attn as wa
    bn, n, c = q.shape
    d = c // heads
    nw = nWh * nWw
    if shift:
        mask = (bias[None] + wa.shift_masks(nWh, nWw, w, shift, DEV)[:, None]
                ).reshape(1, nw * heads, n, n)
        groups = bn // nw
    else:
        mask, groups = bias[None], bn
    mask = mask.to(q.dtype)
    qh, kh, vh = (t.reshape(bn, n, heads, d).transpose(1, 2)
                  .reshape(groups, -1, n, d) for t in (q, k, v))
    times = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.MATH):
        def sdpa():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=d ** -0.5)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                got = sdpa()
        except RuntimeError:
            continue                      # this backend refuses the inputs
        got = got.reshape(bn, heads, n, d).transpose(1, 2).reshape(bn, n, c)
        times[backend.name] = (cuda_ms(sdpa),
                               (got.float() - want.float()).abs().max().item())
    return times


def check_window_attn(cfg, g) -> dict:
    """K2 at the 8 stage/shift shapes, beside SDPA on the same inputs."""
    from fusionocc_tpu_torch.ops import window_attn as wa
    w = cfg.swin.window_size
    n = w * w
    err, ms, plain_ms, lib_ms, bound = 0.0, 0.0, 0.0, 0.0, Bound()
    for nWh, nWw, c, heads in stage_shapes(cfg):
        bn = cfg.num_cams * nWh * nWw
        d = c // heads
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
            err = max(err, check_close(name, got, want, **WA_TOL))
            t_k = cuda_ms(lambda: wa.window_attention_cuda(*args))
            t_p = cuda_ms(lambda: wa.window_attention_plain(*args))
            sdpa = sdpa_times(*args, want)
            if not sdpa:
                fail(f'{name}: no SDPA backend takes these inputs')
            best = min(sdpa, key=lambda b: sdpa[b][0])
            ms, plain_ms = ms + t_k, plain_ms + t_p
            lib_ms += sdpa[best][0]
            print(f'    kernel {t_k:.4f} ms, plain {t_p:.4f} ms; sdpa by '
                  'backend (ms, max abs diff to plain): '
                  + ', '.join(f'{b} {t:.4f} {e:.2e}'
                              for b, (t, e) in sdpa.items())
                  + f'; fastest {best}', flush=True)
            bound.add(4 * bn * heads * n * n * d,
                      4 * bn * n * c * 2 + heads * n * n * 4, torch.bfloat16)
    bound_ms, bound_by = bound.total()
    print(f'  window_attn summed over the 8 shapes: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, sdpa (fastest backend per shape) '
          f'{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}',
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def embedding_bag_pool(depth_flat, feat_flat, ranks_depth, ranks_feat,
                       bounds):
    """K1's function as one PyTorch call, the library yardstick (the port
    never calls it): ``embedding_bag`` sums each voxel's gathered feature
    rows weighted by the gathered depth values.  ranks_*: the in-grid points
    (``bounds[-1]`` of them), int64 like ``bounds``."""
    import torch.nn.functional as F
    return F.embedding_bag(ranks_feat, feat_flat, bounds, mode='sum',
                           per_sample_weights=depth_flat[ranks_depth],
                           include_last_offset=True)


def check_bev_pool(cfg, batch0, g) -> dict:
    """K1 on the full-size pooling index of the synthetic rig: bf16 to bf16
    (the main path) and fp32 to fp32, beside ``embedding_bag`` and the
    zero-fill alone."""
    from fusionocc_tpu_torch.models.fusion_occ import frame_pooling_index
    from fusionocc_tpu_torch.ops import bev_pool as bp
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
    feat32 = torch.randn(B * N * h * wf, C, device=DEV, generator=g)
    feat16 = feat32.bfloat16()
    n_in = int(idx.bounds[-1])
    runs = idx.bounds[1:] - idx.bounds[:-1]
    n_long = idx.long_voxels.numel()
    print(f'  bev_pool index: P={idx.ranks_depth.numel()} in-grid={n_in} '
          f'C={C} voxels={nvox} (non-empty {int((runs > 0).sum())}); '
          f'longest run {int(runs.max())}; work table: {n_long} runs longer '
          f'than {idx.max_short} points (warp items, '
          f'{int(runs[idx.long_voxels.long()].sum())} points)', flush=True)
    cases = {}
    for f_in, out in ((feat16, torch.bfloat16), (feat32, torch.float32),
                      (feat16, torch.float32), (feat32, torch.bfloat16)):
        got = bp.bev_pool_cuda(depth, f_in, idx, nvox, out)
        again = bp.bev_pool_cuda(depth, f_in, idx, nvox, out)
        want = bp.bev_pool_plain(depth, f_in, idx, nvox).to(out)
        torch.cuda.synchronize()
        name = f'bev_pool {f_in.dtype} feat -> {out} out'
        tol = POOL_BF16_TOL if out == torch.bfloat16 else POOL_TOL
        err = check_close(name, got, want, **tol)
        if not torch.equal(got, again):
            fail(f'{name}: two launches differ')
        print('    two launches bit-identical', flush=True)
        cases[out, f_in.dtype] = err
    main_args = (depth, feat16, idx, nvox, torch.bfloat16)
    fp32_args = (depth, feat32, idx, nvox, torch.float32)
    # every point out of the grid: the kernel writes zeros only
    empty = idx._replace(ranks_bev=torch.full_like(idx.ranks_bev, nvox),
                         bounds=torch.zeros_like(idx.bounds),
                         long_voxels=idx.long_voxels[:0])
    if bp.bev_pool_cuda(depth, feat16, empty, nvox, torch.bfloat16).any():
        fail('bev_pool on an index with no in-grid point is not all zeros')
    rd, rf = idx.ranks_depth[:n_in], idx.ranks_feat[:n_in].long()
    bounds64 = idx.bounds.long()
    lib = embedding_bag_pool(depth, feat32, rd, rf, bounds64)
    lib_err = (lib - bp.bev_pool_plain(depth, feat32, idx, nvox)
               ).abs().max().item()
    t_k = cuda_ms(lambda: bp.bev_pool_cuda(*main_args))
    t_k32 = cuda_ms(lambda: bp.bev_pool_cuda(*fp32_args))
    t_p = cuda_ms(lambda: bp.bev_pool_plain(*main_args[:4]).to(
        torch.bfloat16))
    t_lib = cuda_ms(lambda: embedding_bag_pool(depth, feat32, rd, rf,
                                               bounds64))
    t_fill = cuda_ms(lambda: bp.bev_pool_cuda(depth, feat16, empty, nvox,
                                              torch.bfloat16))
    t_fill32 = cuda_ms(lambda: bp.bev_pool_cuda(depth, feat32, empty, nvox,
                                                torch.float32))
    print(f'    per launch: kernel bf16 {t_k:.4f} ms, fp32 {t_k32:.4f} ms; '
          f'plain (bf16 out) {t_p:.4f} ms; embedding_bag (fp32 weights, '
          f'depth gather included) {t_lib:.4f} ms, max abs diff to plain '
          f'{lib_err:.2e}; zero-fill alone (no in-grid point) bf16 '
          f'{t_fill:.4f} ms, fp32 {t_fill32:.4f} ms', flush=True)
    # the in-grid points' two ranks and depth value, every feature row, the
    # work table (bounds and long items), the pooled voxels written
    table = (nvox + 1) * 4 + n_long * 4
    bounds_ms = {}
    for name, f_in, es in (('bf16', feat16, 2), ('fp32', feat32, 4)):
        bound = Bound()
        print(f'    {name} out:', flush=True)
        bound.add(2 * n_in * C, n_in * 12 + f_in.numel() * f_in.element_size()
                  + table + nvox * C * es, torch.float32)
        bounds_ms[name] = bound.total()
    bound_ms, bound_by = bounds_ms['bf16']
    return dict(max_abs_err=cases[torch.bfloat16, torch.bfloat16], ms=t_k,
                plain_ms=t_p, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=t_lib, fp32_max_abs_err=cases[torch.float32,
                                                         torch.float32],
                fp32_ms=t_k32, fp32_bound_ms=bounds_ms['fp32'][0],
                zero_fill_ms=t_fill, fp32_zero_fill_ms=t_fill32)


def check_zwin(cfg, batch0) -> dict:
    """K3 at the full-size encoder's 9 launches, then its microbenchmark
    at stage 1's SubM launch."""
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    from fusionocc_tpu_torch.ops.voxelize import voxelize_mean
    from tools import profile_torch_zwin_micro as micro
    lc = cfg.lidar
    calls = micro.record_zwin_launches(cfg, batch0, DEV)
    sp = voxelize_mean(batch0.points, batch0.points_mask,
                       cfg.grid.point_cloud_range, lc.voxel_size,
                       lc.sparse_shape(cfg.grid), lc.voxel_capacity[0])
    print(f'  full-size cloud: {int(batch0.points_mask.sum())} points, '
          f'{int(sp.mask.sum())} voxels (JAX capacity '
          f'{lc.voxel_capacity[0]})', flush=True)
    caps = cfg.lidar.zfold_capacity
    err, ms, plain_ms, bound = 0.0, 0.0, 0.0, Bound()
    stage = 0
    for feats, mask_out, nbr, weight, f_in, f_out, stride in calls:
        args = (feats, mask_out, nbr, weight, f_in, f_out, stride)
        B, s_in, l_in = feats.shape
        s_out = nbr.shape[1]
        cin, cout = weight.shape[1], weight.shape[2]
        kind = 'subm' if stride == 1 else 'down'
        cap = caps[stage] if stride == 1 else caps[stage + 1]
        name = (f'zwin stage {stage} {kind} Cin {cin}->{cout} L {l_in}->'
                f'{f_out * cout} rows {s_in}->{s_out} (active '
                f'{int(mask_out.sum())}, JAX capacity {cap})')
        got = zw.zwin_conv_cuda(*args)
        want = zw.zwin_conv_plain(*args)
        torch.cuda.synchronize()
        err = max(err, check_close(name, got, want, **ZWIN_TOL))
        t_k = cuda_ms(lambda: zw.zwin_conv_cuda(*args))
        t_p = cuda_ms(lambda: zw.zwin_conv_plain(*args))
        ms, plain_ms = ms + t_k, plain_ms + t_p
        print(f'    kernel {t_k:.4f} ms, plain {t_p:.4f} ms, no single '
              f'PyTorch call', flush=True)
        # found taps of active rows, each over its band's nonzero
        # (zi, zo) cell pairs; feats, nbr, mask and weight read, out written
        found = ((nbr < s_in) & mask_out[..., None]).sum(dim=(0, 1)).tolist()
        macs = sum(found[t] * len(zw.band_pairs(f_in, f_out, stride, t % 3))
                   * cin * cout for t in range(27))
        es = feats.element_size()
        bound.add(2 * macs, feats.numel() * es + nbr.numel() * 4
                  + mask_out.numel() + 27 * cin * cout * es
                  + B * s_out * f_out * cout * es, feats.dtype)
        if stride == 2:
            stage += 1
    if len(calls) != 9:
        fail(f'the full-size encoder made {len(calls)} zwin calls, not 9')
    bound_ms, bound_by = bound.total()
    print(f'  zwin summed over the 9 launches: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}',
          flush=True)
    print('  K3 microbenchmark (tools/profile_torch_zwin_micro.py) at stage '
          "1's SubM launch:", flush=True)
    stage1 = micro.stage1_subm(calls)
    micro.report(micro.run(stage1), stage1, indent='    ')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_edge_shapes(g) -> None:
    """The bf16 bodies at shapes off the main path: K2's padded keys and
    query rows, K3's batch offsets, odd n8 tiles, fewer warps, four k16
    steps."""
    from fusionocc_tpu_torch.ops import window_attn as wa
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    for w, nWh, nWw, heads in ((7, 2, 3, 2), (10, 3, 2, 4)):
        n, c, bn = w * w, 32 * heads, 2 * nWh * nWw
        qkv = torch.randn(bn, n, 3 * c, device=DEV, generator=g
                          ).to(torch.bfloat16)
        bias = torch.randn(heads, n, n, device=DEV, generator=g)
        for shift in (0, w // 2):
            args = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                    nWh, nWw, w, shift, heads)
            check_close(f'edge window_attn N={n} heads={heads} shift={shift}',
                        wa.window_attention_cuda(*args),
                        wa.window_attention_plain(*args), **WA_TOL)
    for B, s_in, s_out, cin, cout, f_in, f_out, stride in (
            (2, 300, 200, 16, 24, 8, 4, 2), (1, 257, 257, 64, 8, 4, 4, 1)):
        feats = torch.randn(B, s_in, f_in * cin, device=DEV, generator=g
                            ).to(torch.bfloat16)
        nbr = torch.randint(0, s_in, (B, s_out, 27), device=DEV, generator=g,
                            dtype=torch.int32)
        miss = torch.rand(B, s_out, 27, device=DEV, generator=g) < 0.3
        nbr = torch.where(miss, s_in, nbr).to(torch.int32)
        mask = torch.rand(B, s_out, device=DEV, generator=g) > 0.2
        weight = 0.1 * torch.randn(27, cin, cout, device=DEV, generator=g)
        args = (feats, mask, nbr, weight, f_in, f_out, stride)
        check_close(f'edge zwin B={B} Cin {cin}->{cout} f {f_in}->{f_out} '
                    f'stride {stride}', zw.zwin_conv_cuda(*args),
                    zw.zwin_conv_plain(*args), **ZWIN_TOL)


@torch.inference_mode()
def phase_kernels(cfg, batch0) -> dict:
    print('[3/5] kernels vs plain versions at main-path shapes')
    g = torch.Generator(device=DEV).manual_seed(1234)
    measured = {'zwin_conv_fwd': check_zwin(cfg, batch0),
                'window_attn_fwd': check_window_attn(cfg, g),
                'bev_pool_fwd': check_bev_pool(cfg, batch0, g)}
    check_edge_shapes(g)
    return measured


def phase_reference() -> None:
    """Midsize multi-modal fp32: the card (kernels) against the CPU (plain
    versions)."""
    from fusionocc_tpu_torch.config import midsize_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    print('[4/5] reference: midsize multi-modal fp32, card vs CPU plain '
          'versions')
    cfg = midsize_model_config(use_lidar=True)
    model = init_weights(FusionOcc(cfg, device='cpu'),
                         torch.Generator().manual_seed(7))
    batch = synthetic_batch(cfg, 1, 0, device='cpu')
    with torch.inference_mode():
        want = model(batch)
        want_lidar = model.lidar_encoder(batch.points, batch.points_mask)
    model.to(DEV)
    batch = synthetic_batch(cfg, 1, 0, device=DEV)
    KERNELS.reset_counts()
    with torch.inference_mode():
        got = model(batch)
        got_lidar = model.lidar_encoder(batch.points, batch.points_mask)
    torch.cuda.synchronize()
    print(f'  launches on the card: {dict(KERNELS.launches)}')
    if min(KERNELS.launches[k] for k in MAIN_KERNELS) == 0:
        fail('a kernel was not launched by the midsize model on the card')
    check_close('midsize lidar feature', got_lidar.cpu(), want_lidar,
                **REF_TOL)
    for key in ('occ_logits', 'depth', 'seg_logits'):
        check_close(f'midsize {key}', got[key].cpu(), want[key], **REF_TOL)
    agree = (got['occ_logits'].argmax(-1).cpu()
             == want['occ_logits'].argmax(-1)).float().mean().item()
    print(f'  midsize argmax agreement {agree:.6f} (need >= 0.999)', flush=True)
    if agree < 0.999:
        fail('midsize argmax agreement below 0.999')


def drive_path(label, cfg, batches, expect) -> dict:
    """Full-size ``predict`` on ``batches`` with seeded random weights:
    launch counts set to 0 just before, read just after."""
    from fusionocc_tpu_torch.models.fusion_occ import (
        FusionOcc, batch_pooling_indices, init_weights)
    from fusionocc_tpu_torch.ops.kernels import KERNELS
    t0 = time.perf_counter()
    model = init_weights(FusionOcc(cfg, device=DEV),
                         torch.Generator().manual_seed(0))
    pool_idxs = batch_pooling_indices(cfg, batches[0])
    torch.cuda.synchronize()
    print(f'  {label}: model + pooling indices ready in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters())} parameters)')
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
          f'depth {tuple(out["depth"].shape)}, seg '
          f'{tuple(out["seg_logits"].shape)}')
    del out, logits

    enc_events = []
    if cfg.use_lidar:
        def pre(mod, args):
            enc_events.append([torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)])
            enc_events[-1][0].record()

        def post(mod, args, result):
            enc_events[-1][1].record()
        hooks = [model.lidar_encoder.register_forward_pre_hook(pre),
                 model.lidar_encoder.register_forward_hook(post)]
    torch.cuda.synchronize()
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
        delta = {k: KERNELS.launches[k] - before[k] for k in MAIN_KERNELS}
        if pred.shape != (1, gx, gy, gz) or pred.dtype != torch.uint8:
            fail(f'predict gave {tuple(pred.shape)} {pred.dtype}')
        if delta != expect:
            fail(f'{label}: launches per predict {delta}, expected {expect}')
    totals = {k: KERNELS.launches[k] for k in MAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    print(f'  {label} predict x{len(batches)}: output (1, {gx}, {gy}, {gz}) '
          f'uint8; launches per predict {expect}, total {totals}')
    print(f'  {label}: ms per predict (median of {len(times)}) '
          f'{statistics.median(times):.1f}, all '
          f'{[round(t, 1) for t in times]}; peak memory '
          f'{peak / 2**30:.2f} GiB', flush=True)
    if cfg.use_lidar:
        for h in hooks:
            h.remove()
        enc_ms = [a.elapsed_time(b) for a, b in enc_events]
        print(f'  {label}: LiDAR encoder device ms per predict (CUDA events) '
              f'median {statistics.median(enc_ms):.2f}, all '
              f'{[round(t, 2) for t in enc_ms]}', flush=True)
    del model
    torch.cuda.empty_cache()
    return totals


def phase_slice(batches) -> dict:
    """The image-only path, then the default multi-modal main path."""
    from fusionocc_tpu_torch.config import (full_model_config,
                                            image_only_model_config)
    print('[5/5] slice: full-size predict, bf16')
    paths = []
    for label, cfg in (('image-only', image_only_model_config()),
                       ('default multi-modal', full_model_config())):
        # one window-attention launch per Swin block and frame, one pooling
        # per frame, one zwin launch per sparse-stage conv (the last stage
        # runs dense)
        lc = cfg.lidar
        sparse = lc.encoder_channels[:min(lc.dense_from,
                                          len(lc.encoder_channels) - 1)]
        expect = {'window_attn_fwd': sum(cfg.swin.depths) * cfg.num_frame,
                  'bev_pool_fwd': cfg.num_frame,
                  'zwin_conv_fwd': sum(map(len, sparse)) * cfg.use_lidar}
        paths.append(drive_path(label, cfg, batches, expect))
    return paths[-1]


def main() -> None:
    card = phase_device()
    phase_build()
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    cfg = full_model_config()
    t0 = time.perf_counter()
    batches = [synthetic_batch(cfg, 1, s, device=DEV) for s in SLICE_SEEDS]
    print(f'  synthetic batches (seeds {SLICE_SEEDS}) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    measured = phase_kernels(cfg, batches[0])
    phase_reference()
    launches = phase_slice(batches)
    sources = {
        'window_attn_fwd': ('fusionocc_tpu_torch/csrc/window_attn.cu',
                            'fusionocc_tpu/ops/pallas/window_attn.py:79'),
        'bev_pool_fwd': ('fusionocc_tpu_torch/csrc/bev_pool.cu',
                         'fusionocc_tpu/ops/pallas/segsum.py:31'),
        'zwin_conv_fwd': ('fusionocc_tpu_torch/csrc/zwin_conv.cu',
                          'fusionocc_tpu/ops/pallas/zwin_conv.py:145'),
    }
    kernels = []
    for name, m in measured.items():
        if launches[name] == 0:
            fail(f'{name} was not launched by the main path')
        kernels.append({'name': name, 'route': 'cuda',
                        'source': sources[name][0],
                        'replaces': sources[name][1],
                        'launches': launches[name], **m})
    print(f'card: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
