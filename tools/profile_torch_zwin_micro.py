"""K3's GPU microbenchmark: where the time of one zwin conv goes on the card.

    python3 tools/profile_torch_zwin_micro.py [--reps 20]

The port of ``tools/profile_zwin_micro.py`` (the TPU tool's null,
static-window and compute-only bodies) for the bf16 tensor-core body of
``fusionocc_tpu_torch/csrc/zwin_conv.cu``.  At the TPU tool's shape, stage
1's SubM conv (Cin = Cout = 32, fold 8), with the inputs that the port's
full-size LiDAR encoder (seeded random weights) gives it on the synthetic
cloud, it times:

  a. the plain version (``zwin_conv_plain``, a gather and a cuBLAS GEMM);
  b. K3 on the real neighbour map;
  d. the null body (entry ``zwin_conv_null``): K3's gathers and stores with
     the products left out;
  e. K3 on a contiguous map: tap t of row r reads row r + t - 13 (clipped),
     and misses where the real map has them, so the work is (b)'s and only
     the rows' scatter differs;
  f. K3 on a compute-only map: each hit of row r at tap t reads row
     (r + t) % 32, one 32-row block that stays in L1, so the gathers cost
     least and the tensor-core work is (b)'s;

and prints each time (CUDA events over ``--reps`` calls) and its share of
(b), then the tensor-core work of the call: what the inputs need (each
found tap of an active row times its band's valid (zo, zi) cell pairs,
the count of ``chip_smoke.py``'s bound) and what the bf16 body issues
(for each tap that some active row of a tile finds, each dz and each
consumer warpgroup with a valid (zo, zi) pair among its out cells, all of
its m64 blocks, every row of them).  (b), (e) and (f) compute the contract on their maps and are held
against the plain version within ``chip_smoke.ZWIN_TOL`` (one bf16 ulp);
(d) is checked to run without a CUDA error.  ``chip_smoke.py`` phase 3 runs it once.  Needs a CUDA
GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import ZWIN_TOL, check_close, cuda_ms  # noqa: E402


def record_zwin_launches(cfg, batch, device='cuda'):
    """The arguments of the zwin conv calls (9 at full size) that the
    port's LiDAR encoder, seeded random weights, makes on ``batch``."""
    from fusionocc_tpu_torch.models import lidar_encoder as le
    from fusionocc_tpu_torch.models.fusion_occ import init_weights
    enc = init_weights(le.SparseEncoder(cfg.lidar, cfg.grid, cfg.dtype,
                                        device),
                       torch.Generator().manual_seed(5))
    calls = []

    def record(*args):
        calls.append(args)
        return real(*args)
    real, le.zwin_conv = le.zwin_conv, record
    try:
        with torch.inference_mode():
            enc(batch.points, batch.points_mask)
    finally:
        le.zwin_conv = real
    return calls


def contiguous_map(nbr: torch.Tensor, s_in: int) -> torch.Tensor:
    """(e): tap t of row r reads row r + t - 13, clipped; misses kept."""
    r = torch.arange(nbr.shape[1], device=nbr.device)[:, None]
    t = torch.arange(27, device=nbr.device)
    rows = (r + t - 13).clamp(0, s_in - 1).to(torch.int32)
    return torch.where(nbr < s_in, rows, nbr)


def compute_only_map(nbr: torch.Tensor, s_in: int) -> torch.Tensor:
    """(f): each hit of row r at tap t reads row (r + t) % 32; misses kept."""
    r = torch.arange(nbr.shape[1], device=nbr.device)[:, None]
    t = torch.arange(27, device=nbr.device)
    rows = ((r + t) % 32).to(torch.int32)
    return torch.where(nbr < s_in, rows, nbr)


def stage1_subm(calls):
    """The first SubM call with Cin = Cout = 32: stage 1's."""
    for args in calls:
        weight, stride = args[3], args[6]
        if stride == 1 and tuple(weight.shape[1:]) == (32, 32):
            return args
    raise RuntimeError('no stage-1 SubM call (Cin = Cout = 32) recorded')


def tensor_core_work(args):
    """(needed, issued) GFLOP of one call, counted from its neighbour map
    and mask (see the module docstring)."""
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    feats, mask_out, nbr, weight, f_in, f_out, stride = args
    cin, cout = weight.shape[1], weight.shape[2]
    bands = zw.z_bands(f_in, f_out, stride)
    zb = zw.built_bf16_plan(cin, cout, max(n for _, n in bands))[0]
    rows_t = zw.TILE // zb
    half = -(-f_out // (2 * zb)) * zb          # out cells of warpgroup 0
    found = ((nbr < feats.shape[1]) & mask_out[..., None]).reshape(-1, 27)
    tiles = torch.cat([found, found.new_zeros(-found.shape[0] % rows_t, 27)]
                      ).view(-1, rows_t, 27).any(1)
    needed_t, issued_t = [], []
    for t in range(27):
        pairs = zw.band_pairs(f_in, f_out, stride, t % 3)
        needed_t.append(2 * cin * cout * len(pairs))
        # per dz, each warpgroup with a valid pair runs all its 4 / zb
        # m64 blocks
        groups = sum(any((zo, dz) in pairs for zo in
                         range(wg * half, min(f_out, (wg + 1) * half)))
                     for dz in range(3) for wg in range(2))
        issued_t.append(groups * (4 // zb) * zw.TILE * 2 * cin * cout)
    as_t = lambda x: torch.tensor(x, dtype=torch.float64, device=nbr.device)
    needed = (found.sum(0).double() * as_t(needed_t)).sum().item()
    issued = (tiles.sum(0).double() * as_t(issued_t)).sum().item()
    return needed / 1e9, issued / 1e9


@torch.inference_mode()
def run(args, reps: int = 20) -> dict:
    """Time variants a, b, d, e, f on one recorded call; returns
    {variant: (ms, share of b, max abs error or None)}."""
    from fusionocc_tpu_torch.ops import zwin_conv as zw
    feats, mask_out, nbr, weight, f_in, f_out, stride = args
    s_in = feats.shape[1]
    rest = (weight, f_in, f_out, stride)
    maps = {'real': nbr, 'contiguous': contiguous_map(nbr, s_in),
            'compute-only': compute_only_map(nbr, s_in)}
    for name, m in maps.items():
        if m.dtype != torch.int32 or not bool(((m >= 0) & (m <= s_in)).all()):
            raise RuntimeError(f'{name} map is not a neighbour map')
    variants = {
        'a. plain': (zw.zwin_conv_plain, 'real', False),
        'b. K3, real map': (zw.zwin_conv_cuda, 'real', True),
        'd. null body (gathers, no products)': (zw.zwin_conv_null_cuda,
                                                'real', False),
        'e. K3, contiguous map': (zw.zwin_conv_cuda, 'contiguous', True),
        'f. K3, compute-only map': (zw.zwin_conv_cuda, 'compute-only', True),
    }
    times = {}
    for label, (fn, m, held) in variants.items():
        call = (feats, mask_out, maps[m]) + rest
        got = fn(*call)
        torch.cuda.synchronize()
        err = (check_close(label, got, zw.zwin_conv_plain(*call), **ZWIN_TOL)
               if held else None)
        times[label] = (cuda_ms(lambda: fn(*call), reps=reps), err)
    base = times['b. K3, real map'][0]
    return {k: (t, t / base, e) for k, (t, e) in times.items()}


def report(results: dict, args, indent: str = '') -> None:
    for label, (ms, share, err) in results.items():
        held = (f', max abs err vs plain {err:.3e}' if err is not None
                else '')
        print(f'{indent}{label:40s} {ms:9.4f} ms  {share:7.3f} of b{held}',
              flush=True)
    needed, issued = tensor_core_work(args)
    print(f'{indent}tensor-core work: needed {needed:.3f} GFLOP, issued '
          f'{issued:.3f} GFLOP ({issued / needed:.2f}x)', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    from fusionocc_tpu_torch.config import full_model_config
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True
    ).stdout.strip()
    print(f'card: {card}')
    cfg = full_model_config()
    call = stage1_subm(record_zwin_launches(cfg, synthetic_batch(cfg, 1, 0)))
    feats, mask_out, nbr = call[:3]
    print(f'stage-1 SubM: feats {tuple(feats.shape)} {feats.dtype}, nbr '
          f'{tuple(nbr.shape)}, active rows {int(mask_out.sum())}, found '
          f'taps {int((nbr < feats.shape[1]).sum())}', flush=True)
    report(run(call, opts.reps), call)


if __name__ == '__main__':
    main()
