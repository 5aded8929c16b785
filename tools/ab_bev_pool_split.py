"""K1's tuning choices, on the card: where short runs end, and the rows in
flight and registers of a short group.

    python3 tools/ab_bev_pool_split.py [--reps 20] [--max-short 8 16 32]
        [--variants 4,4 8,4 4,3 8,3 4,5]

K1 (``fusionocc_tpu_torch/csrc/bev_pool.cu``) sums a voxel's run of at
most ``max_short`` points in a group of C/8 lanes and hands a longer run
to a whole warp (the index's work table, ``ops/bev_pool.long_runs``).  A
short group has ``kShortRows`` feature rows in flight per batch, and
``__launch_bounds__`` asks for ``kMinBlocks`` blocks of 256 threads per SM,
which caps the registers.  Each ``--variants`` entry ``rows,blocks`` builds
the kernels from a copy of ``csrc/`` with those two constants replaced (the
first entry is the shipped pair).  On the full-size pooling index of the
synthetic rig (frame 0, as ``chip_smoke.py`` builds it) with the work table
rebuilt for each ``max_short``, and on an index with no in-grid point (the
zero-fill alone), every variant and table is checked against
``bev_pool_plain`` within ``chip_smoke``'s tolerances and timed (CUDA
events) with bf16 features to bf16 voxels (the main path) and fp32 to fp32,
in turns: all cases in order, then in reverse.  It prints the mean of the
two turns per case.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from fusionocc_tpu_torch.config import full_model_config  # noqa: E402
from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import \
    frame_pooling_index  # noqa: E402
from fusionocc_tpu_torch.ops import bev_pool as bp  # noqa: E402
from fusionocc_tpu_torch.ops import kernels  # noqa: E402


def variant_library(rows: int, blocks: int) -> kernels.KernelLibrary:
    """The kernels built from a copy of ``csrc/`` with K1's
    ``kShortRows`` and ``kMinBlocks`` replaced."""
    src_dir = kernels.BUILD_DIR / f'ab_bev_pool_{rows}_{blocks}_csrc'
    src_dir.mkdir(parents=True, exist_ok=True)
    for src in kernels.CSRC.glob('*.cu*'):
        text = src.read_text()
        if src.name == 'bev_pool.cu':
            for name, value in (('kShortRows', rows), ('kMinBlocks', blocks)):
                text, n = re.subn(rf'constexpr int {name} = \d+;',
                                  f'constexpr int {name} = {value};', text)
                if n != 1:
                    raise RuntimeError(f'bev_pool.cu has no {name} to set')
        (src_dir / src.name).write_text(text)
    return kernels.KernelLibrary(
        kernels.BUILD_DIR / f'ab_bev_pool_{rows}_{blocks}', src_dir)


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--max-short', type=int, nargs='+', default=[8, 16, 32])
    ap.add_argument('--variants', nargs='+',
                    default=['4,4', '8,4', '4,3', '8,3', '4,5'])
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA GPU')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f'card: {card}', flush=True)
    variants = [tuple(map(int, v.split(','))) for v in opts.variants]
    libs = {v: variant_library(*v) for v in variants}
    for lib in libs.values():      # the builds run before anything is timed
        lib.load()
    for v, lib in libs.items():
        regs = [line.split('Used', 1)[1].split(',')[0].strip()
                for line in lib.build_log.splitlines()
                if 'Used' in line and 'barriers' in line]
        spills = sorted({line.strip() for line in lib.build_log.splitlines()
                         if 'spill stores' in line})
        print(f'variant rows,blocks {v}: build {lib.build_seconds:.1f} s; '
              f'registers per body {regs}; {spills}', flush=True)
    cfg = full_model_config()
    b = synthetic_batch(cfg, 1, 0, device=cs.DEV)
    idx = frame_pooling_index(cfg, b.sensor2keyego[:, 0], b.intrins[:, 0],
                              b.post_rots[:, 0], b.post_trans[:, 0], b.bda)
    gx, gy, gz = cfg.grid.grid_size
    nvox = gz * gy * gx
    h, wf = cfg.feat_size
    C = cfg.vt.feature_channels
    g = torch.Generator(device=cs.DEV).manual_seed(1234)
    depth = torch.softmax(torch.randn(1, cfg.num_cams, cfg.grid.num_depth_bins,
                                      h, wf, device=cs.DEV, generator=g),
                          dim=2).reshape(-1)
    feat32 = torch.randn(cfg.num_cams * h * wf, C, device=cs.DEV, generator=g)
    feats = {torch.bfloat16: feat32.bfloat16(), torch.float32: feat32}
    tables = {f'max_short {L}': idx._replace(
        long_voxels=bp.long_runs(idx.bounds, L), max_short=L)
        for L in opts.max_short}
    tables['no in-grid point'] = idx._replace(
        ranks_bev=torch.full_like(idx.ranks_bev, nvox),
        bounds=torch.zeros_like(idx.bounds), long_voxels=idx.long_voxels[:0])
    cases = [(v, L, out) for v in libs for L in tables for out in feats]
    times = {case: [] for case in cases}
    try:
        for v, L, out in cases:
            bp.KERNELS = libs[v]
            f = feats[out]
            got = bp.bev_pool_cuda(depth, f, tables[L], nvox, out)
            want = bp.bev_pool_plain(depth, f, tables[L], nvox).to(out)
            tol = cs.POOL_BF16_TOL if out == torch.bfloat16 else cs.POOL_TOL
            cs.check_close(f'rows,blocks {v} {L} {out}', got, want, **tol)
        for order in (cases, cases[::-1]):
            for v, L, out in order:
                bp.KERNELS = libs[v]
                times[v, L, out].append(cs.cuda_ms(
                    lambda: bp.bev_pool_cuda(depth, feats[out], tables[L],
                                             nvox, out), reps=opts.reps))
    finally:
        bp.KERNELS = kernels.KERNELS
    for v, L, out in cases:
        t = times[v, L, out]
        print(f'rows,blocks {v} {L} '
              f'({tables[L].long_voxels.numel()} warp items) '
              f'{str(out).split(".")[-1]}: {sum(t) / len(t):.4f} ms per '
              f'launch {t}', flush=True)


if __name__ == '__main__':
    main()
