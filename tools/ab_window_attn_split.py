"""What splitting P costs in K2's bf16 body, on the card.

    python3 tools/ab_window_attn_split.py [--reps 10]

K2's tensor-core body (``fusionocc_tpu_torch/csrc/window_attn.cu``) takes
O = P V as two bf16 products, of P's high part and of its low part, because
P in bf16 alone is two output ulps off the fp32 softmax of the contract.
This builds a second library from a copy of the sources with the low
products taken out (P in bf16 alone, as SDPA takes it) and runs both forms
at the 8 stage/shift shapes of the full-size Swin-B, on ``chip_smoke.py``'s
inputs, in turns: split, bf16 P, bf16 P, split.  For each form it prints
the time summed over the shapes (the mean of its two turns, CUDA events),
its max abs error against ``window_attention_plain`` and whether that is
within ``chip_smoke.WA_TOL``.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from fusionocc_tpu_torch.config import full_model_config  # noqa: E402
from fusionocc_tpu_torch.ops import kernels  # noqa: E402
from fusionocc_tpu_torch.ops import window_attn as wa  # noqa: E402

LO_PRODUCTS = """            hw::wgmma_m64n32k16_rs<1>(o_lo, lo[kk], dv, 1);
"""


def bf16_p_library() -> kernels.KernelLibrary:
    """The kernels built from a copy of ``csrc/`` without K2's low
    products."""
    src_dir = kernels.BUILD_DIR / 'ab_bf16_p_csrc'
    src_dir.mkdir(parents=True, exist_ok=True)
    for src in kernels.CSRC.glob('*.cu*'):
        text = src.read_text()
        if src.name == 'window_attn.cu':
            if LO_PRODUCTS not in text:
                raise RuntimeError('window_attn.cu has no low products to '
                                   'take out')
            text = text.replace(LO_PRODUCTS, '')
        (src_dir / src.name).write_text(text)
    return kernels.KernelLibrary(kernels.BUILD_DIR / 'ab_bf16_p', src_dir)


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=10)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA GPU')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True
    ).stdout.strip()
    print(f'card: {card}')
    libs = {'split (shipped)': kernels.KERNELS, 'bf16 P': bf16_p_library()}
    for lib in libs.values():
        lib.load()
    cfg = full_model_config()
    w = cfg.swin.window_size
    g = torch.Generator(device=cs.DEV).manual_seed(1234)
    shapes = []
    for nWh, nWw, c, heads in cs.stage_shapes(cfg):
        bn = cfg.num_cams * nWh * nWw
        qkv = torch.randn(bn, w * w, 3 * c, device=cs.DEV, generator=g
                          ).to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        bias = torch.randn(heads, w * w, w * w, device=cs.DEV, generator=g)
        for shift in (0, w // 2):
            args = (q, k, v, bias, nWh, nWw, w, shift, heads)
            shapes.append((args, wa.window_attention_plain(*args).float()))
    ms = {name: 0.0 for name in libs}
    err = {name: 0.0 for name in libs}
    ok = {name: True for name in libs}
    try:
        for name in ('split (shipped)', 'bf16 P', 'bf16 P',
                     'split (shipped)'):
            wa.KERNELS = libs[name]
            for args, want in shapes:
                got = wa.window_attention_cuda(*args).float()
                diff = (got - want).abs()
                err[name] = max(err[name], diff.max().item())
                ok[name] &= bool((diff <= cs.WA_TOL['atol']
                                  + cs.WA_TOL['rtol'] * want.abs()).all())
                ms[name] += cs.cuda_ms(lambda: wa.window_attention_cuda(
                    *args), reps=opts.reps) / 2
    finally:
        wa.KERNELS = kernels.KERNELS
    for name in libs:
        print(f'{name:16s} {ms[name]:.4f} ms over the 8 shapes, max abs err '
              f'{err[name]:.3e}, within WA_TOL {cs.WA_TOL}: {ok[name]}',
              flush=True)


if __name__ == '__main__':
    main()
