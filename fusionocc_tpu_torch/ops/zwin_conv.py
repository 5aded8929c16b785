"""The z-folded 3x3x3 sparse conv: the plain version and the CUDA kernel.

Port of ``fusionocc_tpu/ops/pallas/zwin_conv.py``.  Both versions compute
the JAX contract ``ops/zfold.py::zband_conv_apply``:

    out[b, s, zo*Cout + co] = mask_out[b, s] *
        sum over taps t with nbr[b, s, t] < S_in, over the in cells
        r = stride*zo + dz - 1 (dz = 0..2) of super shift ds = t % 3:
            sum over ci of feats[b, nbr[b, s, t], zi(r)*Cin + ci]
                           * weight[t - ds + dz, ci, co]

summed in fp32 over all taps and cast to feats' dtype once.  feats (B, S_in,
f_in*Cin), zi-major lanes; nbr (B, S_out, 27) int32 super-grid neighbour map
in ``KERNEL_OFFSETS`` order, miss = S_in; weight (27, Cin, Cout).  SubM
convs have stride 1 and f_out = f_in; stride-2 convs take f_out = min(F,
out cells in z).

The lifted weight (``expand_weight``) is z-banded: for super z-shift ds only
the input lanes of ``z_bands(...)[ds]`` are nonzero, and out cell zo reads
at most 3 of them.  The plain version multiplies each band by its lifted
weight; the kernel reads the cell weight at tap t - ds + dz directly.

The TPU kernel's window plan, one-hot row selection, overflow patch and
``lax.cond`` fallback exist only because Mosaic had no dynamic gather; the
CUDA kernel gathers rows by index, so it is exact and has none of them.
``zwin_conv`` is the autograd ``Function`` ``ZwinConv`` around the custom
op ``fusionocc::zwin_conv`` (``zwin_conv_op``): its CPU implementation is
the plain version, its CUDA one launches ``csrc/zwin_conv.cu``; it never
falls back.  Its backward is JAX's ``_zwin_bwd``, the
VJP of the plain contract recomputed from the saved (feats, weight), the
same code on both devices.  The kernel
has two bodies, chosen by dtype: bf16 runs on Hopper's warpgroup products
(Cin a multiple of 16 up to 64, Cout a multiple of 8 up to 64, f_out <= 8;
the wrapper hands it the cell kernel transposed, (27, Cout, Cin), which it
keeps resident in shared memory; ``bf16_plan`` is its launch plan), fp32 on
the CUDA cores (L_out <= 1024).  A bf16 input that the Hopper body does not
take raises.

``zwin_conv_epi`` is the eval path with the BatchNorm fused in
(``SparseEncoderConfig.zwin_fuse``), the port of JAX's
``_epilogue_in_kernel`` reached through ``zwin_conv_infer``: the fp32 sums
times ``inv``, plus ``shift`` (the (L_out,) affine of the BatchNorm tiled
over the fold), ReLU, times the (B, S_out, f_out) cell lane mask, then one
cast; zero at rows off ``mask_out``.  Both bodies apply it to their fp32
accumulators before their single store (C entry ``zwin_conv_fwd_epi``),
reading the compact lane mask, not JAX's (B, S_out, L_out) multiplier.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from .kernels import KERNELS, stream_ptr
from .sparse_conv import gather_rows
from .zfold import expand_lane_mask, expand_weight

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_L_OUT = 1024    # fp32 body: one thread per output lane
MAX_CHANNELS = 64   # bf16 body: Cin and Cout
MAX_F_OUT = 8       # bf16 body: two warpgroups of at most four out cells
# the bf16 body's launch plan (csrc/zwin_conv.cu pick_plan), copied for the
# CPU tests and tools, which have no library; chip_smoke.py holds
# ``bf16_plan`` to ``built_bf16_plan`` at every launch it checks: the M of a
# product, the shared memory a block may use, the ring's stages, bytes of a
# stage header, of the producer's two row tables and of the barriers
TILE, SMEM_MAX, MIN_STAGES, MAX_STAGES = 64, 232448, 3, 8
HEADER = 16
TABLE_BYTES = 2 * (TILE * 27 * 4 + 16)
BARRIER_BYTES = (2 * MAX_STAGES + 5) * 8


def bf16_plan(cin: int, cout: int, nzi_max: int):
    """The bf16 body's (zb, Cout parts, stages), as ``launch_bf16`` picks
    them: per block size zb (m64 blocks of zb out cells and 64 / zb rows of
    a tile), the fewest Cout parts (each a multiple of 8) whose resident
    cell kernel fits beside MIN_STAGES stages of gathered rows, then as many
    stages as fit; the smallest zb of the fewest parts."""
    row_pitch = max(nzi_max, 1) * cin * 2 + 16
    nt = cout // 8
    best = None
    for zb in (1, 2, 4):
        stage = (HEADER + TILE // zb * row_pitch + 15) // 16 * 16
        for parts in range(1, nt + 1):
            if nt % parts or (best and parts >= best[1]):
                continue
            w_bytes = (27 * cin * (cout // parts) * 2 + 1023) // 1024 * 1024
            fit = (SMEM_MAX - 1024 - w_bytes - 32 - TABLE_BYTES
                   - BARRIER_BYTES) // stage
            if fit >= MIN_STAGES:
                best = (zb, parts, min(fit, MAX_STAGES))
                break
    if best is None:
        raise ValueError(f'no bf16 plan for Cin {cin}, Cout {cout}')
    return best


def built_bf16_plan(cin: int, cout: int, nzi_max: int):
    """The (zb, Cout parts, stages) that the built library's
    ``launch_bf16`` picks (C entry ``zwin_conv_plan``); needs the built
    kernels."""
    plan = (ctypes.c_int * 3)()
    if KERNELS.load().zwin_conv_plan(cin, cout, nzi_max, plan) != 0:
        raise ValueError(f'no bf16 plan for Cin {cin}, Cout {cout}')
    return tuple(plan)


def band_pairs(f_in: int, f_out: int, stride: int, ds: int):
    """The (zo, dz) pairs whose input cell lies in super shift ds."""
    return [(zo, dz) for zo in range(f_out) for dz in range(3)
            if (stride * zo + dz - 1) // f_in + 1 == ds]


def z_bands(f_in: int, f_out: int, stride: int) -> List[Tuple[int, int]]:
    """Nonzero (zi_lo, nzi) input-lane band per super z-shift ds in 0..2;
    nzi == 0 for an empty ds."""
    bands = []
    for ds in range(3):
        zis = [stride * zo + dz - 1 - (ds - 1) * f_in
               for zo, dz in band_pairs(f_in, f_out, stride, ds)]
        bands.append((min(zis), max(zis) - min(zis) + 1) if zis else (0, 0))
    return bands


def _zwin_sums(feats: torch.Tensor, nbr_idx: torch.Tensor,
               weight: torch.Tensor, f_in: int, f_out: int,
               stride: int) -> torch.Tensor:
    """``zband_conv_apply``'s fp32 sums, unmasked: per super shift ds,
    gather the band lanes of the 9 (dx, dy) taps and run one fp32 GEMM
    against the band of the lifted weight.  feats is widened to fp32
    before the bands are cut and gathered, so the backward sums a row's
    tap and band gradients in fp32 and rounds them to feats' dtype
    once."""
    B, _, L = feats.shape
    cin, cout = weight.shape[1], weight.shape[2]
    assert L == f_in * cin, (L, f_in, cin)
    assert stride * (f_out - 1) + 1 <= 2 * f_in, (f_in, f_out, stride)
    s_out = nbr_idx.shape[1]
    w_e = expand_weight(weight.to(feats.dtype).float(), f_in, f_out, stride)
    w_e = w_e.reshape(9, 3, f_in, cin, f_out, cout)
    nbr9 = nbr_idx.reshape(B, s_out, 9, 3)
    out = feats.new_zeros(B, s_out, f_out * cout, dtype=torch.float32)
    feats = feats.float()
    for ds, (zi_lo, nzi) in enumerate(z_bands(f_in, f_out, stride)):
        if not nzi:
            continue
        zos = [zo for zo, _ in band_pairs(f_in, f_out, stride, ds)]
        zo_lo, zo_hi = min(zos), max(zos)
        src = feats[:, :, zi_lo * cin:(zi_lo + nzi) * cin]
        gat = gather_rows(src, nbr9[..., ds]).reshape(B, s_out, 9 * nzi * cin)
        wk = w_e[:, ds, zi_lo:zi_lo + nzi, :, zo_lo:zo_hi + 1].reshape(
            9 * nzi * cin, (zo_hi - zo_lo + 1) * cout)
        out[:, :, zo_lo * cout:(zo_hi + 1) * cout] += gat @ wk
    return out


def zwin_conv_plain(feats: torch.Tensor, mask_out: torch.Tensor,
                    nbr_idx: torch.Tensor, weight: torch.Tensor,
                    f_in: int, f_out: int, stride: int) -> torch.Tensor:
    """``zband_conv_apply``: the fp32 sums cast once, zero off
    ``mask_out``."""
    out = _zwin_sums(feats, nbr_idx, weight, f_in, f_out, stride)
    return torch.where(mask_out[..., None], out.to(feats.dtype), 0)


def zwin_conv_epi_plain(feats: torch.Tensor, mask_out: torch.Tensor,
                        nbr_idx: torch.Tensor, weight: torch.Tensor,
                        f_in: int, f_out: int, stride: int,
                        inv: torch.Tensor, shift: torch.Tensor,
                        lane_mask: torch.Tensor) -> torch.Tensor:
    """The conv with the fused eval epilogue, in the order of JAX's
    ``_epilogue_in_kernel``: the fp32 sums (before any cast) times ``inv``
    plus ``shift`` ((L_out,) fp32), ReLU, times the lane mask (B, S_out,
    f_out), all in fp32, then one cast; zero off ``mask_out``."""
    cout = weight.shape[2]
    y = _zwin_sums(feats, nbr_idx, weight, f_in, f_out, stride)
    y = torch.relu(y * inv.float() + shift.float())
    y = y * expand_lane_mask(lane_mask, cout, torch.float32)
    return torch.where(mask_out[..., None], y.to(feats.dtype), 0)


def zwin_conv_cuda(feats: torch.Tensor, mask_out: torch.Tensor,
                   nbr_idx: torch.Tensor, weight: torch.Tensor,
                   f_in: int, f_out: int, stride: int) -> torch.Tensor:
    """Launch ``zwin_conv_fwd``."""
    return _launch('zwin_conv_fwd', feats, mask_out, nbr_idx, weight, f_in,
                   f_out, stride)


def zwin_conv_null_cuda(feats: torch.Tensor, mask_out: torch.Tensor,
                        nbr_idx: torch.Tensor, weight: torch.Tensor,
                        f_in: int, f_out: int, stride: int) -> torch.Tensor:
    """Launch ``zwin_conv_null``, the bf16 body with the products left out:
    the same gathers and stores, an output of masked zeros.  It times the
    data movement alone (``tools/profile_torch_zwin_micro.py``)."""
    if feats.dtype != torch.bfloat16:
        raise TypeError(f'the null body is bf16 only, got {feats.dtype}')
    return _launch('zwin_conv_null', feats, mask_out, nbr_idx, weight, f_in,
                   f_out, stride)


def zwin_conv_epi_cuda(feats: torch.Tensor, mask_out: torch.Tensor,
                       nbr_idx: torch.Tensor, weight: torch.Tensor,
                       f_in: int, f_out: int, stride: int,
                       inv: torch.Tensor, shift: torch.Tensor,
                       lane_mask: torch.Tensor) -> torch.Tensor:
    """Launch ``zwin_conv_fwd_epi``: K3 with the BatchNorm affine, ReLU and
    lane mask applied to its accumulators before the store."""
    dev = feats.device
    l_out = f_out * weight.shape[2]
    if (tuple(inv.shape) != (l_out,) or tuple(shift.shape) != (l_out,)
            or tuple(lane_mask.shape) != (*nbr_idx.shape[:2], f_out)):
        raise ValueError(f'epilogue shapes: inv {tuple(inv.shape)}, shift '
                         f'{tuple(shift.shape)}, lane_mask '
                         f'{tuple(lane_mask.shape)}; L_out {l_out}, f_out '
                         f'{f_out}')
    if lane_mask.dtype != torch.bool or lane_mask.device != dev:
        raise ValueError(f'lane_mask must be bool on {dev}')
    epi = (inv.to(dev, torch.float32).contiguous(),
           shift.to(dev, torch.float32).contiguous(), lane_mask.contiguous())
    return _launch('zwin_conv_fwd_epi', feats, mask_out, nbr_idx, weight,
                   f_in, f_out, stride, epi)


def _launch(entry: str, feats, mask_out, nbr_idx, weight, f_in: int,
            f_out: int, stride: int, epi=()) -> torch.Tensor:
    """Check the operands and launch C entry ``entry``; ``epi`` is the
    fused epilogue's (inv, shift, lane_mask), passed after the weight."""
    dev = feats.device
    if dev.type != 'cuda':
        raise ValueError(f'zwin_conv_cuda needs CUDA tensors, got {dev}')
    if feats.dtype not in _DTYPE_CODE:
        raise TypeError(f'feats must be float32 or bfloat16, got '
                        f'{feats.dtype}')
    B, s_in, l_in = feats.shape
    _, s_out, taps = nbr_idx.shape
    cin, cout = weight.shape[1], weight.shape[2]
    l_out = f_out * cout
    if (weight.shape[0] != 27 or l_in != f_in * cin or taps != 27
            or nbr_idx.shape[0] != B or mask_out.shape != (B, s_out)):
        raise ValueError(f'shapes: feats {tuple(feats.shape)}, nbr '
                         f'{tuple(nbr_idx.shape)}, mask_out '
                         f'{tuple(mask_out.shape)}, weight '
                         f'{tuple(weight.shape)}, f_in {f_in}')
    if stride * (f_out - 1) + 1 > 2 * f_in or l_out > MAX_L_OUT:
        raise ValueError(f'unsupported fold f_in={f_in} f_out={f_out} '
                         f'stride={stride} L_out={l_out}')
    if feats.dtype == torch.bfloat16 and (
            cin % 16 or cout % 8 or max(cin, cout) > MAX_CHANNELS
            or f_out > MAX_F_OUT):
        raise ValueError(f'the bf16 body takes Cin a multiple of 16 and Cout '
                         f'a multiple of 8, both <= {MAX_CHANNELS}, and '
                         f'f_out <= {MAX_F_OUT}; got Cin={cin}, Cout={cout}, '
                         f'f_out={f_out}')
    if (nbr_idx.dtype != torch.int32 or mask_out.dtype != torch.bool
            or nbr_idx.device != dev or mask_out.device != dev):
        raise ValueError(f'nbr_idx must be int32 and mask_out bool on {dev}')
    if B * max(s_in, s_out) >= 2 ** 31:
        raise ValueError('row count exceeds int32')
    feats = feats.contiguous()
    nbr_idx = nbr_idx.contiguous()
    mask_out = mask_out.contiguous()
    weight = weight.to(dev, feats.dtype)
    if feats.dtype == torch.bfloat16:
        # the bf16 body keeps the cell kernel K-major in shared memory
        weight = weight.transpose(1, 2)
    weight = weight.contiguous()
    bands = [v for band in z_bands(f_in, f_out, stride) for v in band]
    out = torch.empty(B, s_out, l_out, dtype=feats.dtype, device=dev)
    if B * s_out == 0:
        return out
    with torch.cuda.device(dev):
        KERNELS.launch(
            entry, feats.data_ptr(), nbr_idx.data_ptr(),
            mask_out.data_ptr(), weight.data_ptr(),
            *(t.data_ptr() for t in epi), out.data_ptr(), B, s_in,
            s_out, cin, cout, stride, l_in, l_out, *bands,
            _DTYPE_CODE[feats.dtype],
            stream_ptr(dev))
    return out


def zwin_conv_bwd(feats: torch.Tensor, mask_out: torch.Tensor,
                  nbr_idx: torch.Tensor, weight: torch.Tensor, f_in: int,
                  f_out: int, stride: int, g: torch.Tensor):
    """JAX's ``_zwin_bwd``: (d_feats, d_weight), the VJP of
    ``zwin_conv_plain`` at (feats, weight) for the cotangent g."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_()
        w = weight.detach().requires_grad_()
        y = zwin_conv_plain(f, mask_out, nbr_idx, w, f_in, f_out, stride)
        return torch.autograd.grad(y, (f, w), g)


@torch.library.custom_op('fusionocc::zwin_conv', mutates_args=(),
                         device_types='cpu')
def zwin_conv_op(feats: torch.Tensor, mask_out: torch.Tensor,
                 nbr_idx: torch.Tensor, weight: torch.Tensor, f_in: int,
                 f_out: int, stride: int) -> torch.Tensor:
    """K3 as a custom op: on the CPU the plain version."""
    return zwin_conv_plain(feats, mask_out, nbr_idx, weight, f_in, f_out,
                           stride)


@zwin_conv_op.register_kernel('cuda')
def _zwin_conv_op_cuda(feats, mask_out, nbr_idx, weight, f_in, f_out,
                       stride):
    # the wrapper by its module name, so a caller may wrap it
    return zwin_conv_cuda(feats, mask_out, nbr_idx, weight, f_in, f_out,
                          stride)


@zwin_conv_op.register_fake
def _zwin_conv_op_fake(feats, mask_out, nbr_idx, weight, f_in, f_out,
                       stride):
    return feats.new_empty(feats.shape[0], nbr_idx.shape[1],
                           f_out * weight.shape[2])


@torch.library.custom_op('fusionocc::zwin_conv_epi', mutates_args=(),
                         device_types='cpu')
def zwin_conv_epi_op(feats: torch.Tensor, mask_out: torch.Tensor,
                     nbr_idx: torch.Tensor, weight: torch.Tensor, f_in: int,
                     f_out: int, stride: int, inv: torch.Tensor,
                     shift: torch.Tensor, lane_mask: torch.Tensor
                     ) -> torch.Tensor:
    """K3 with its fused eval epilogue as a custom op: on the CPU the plain
    version."""
    return zwin_conv_epi_plain(feats, mask_out, nbr_idx, weight, f_in, f_out,
                               stride, inv, shift, lane_mask)


@zwin_conv_epi_op.register_kernel('cuda')
def _zwin_conv_epi_op_cuda(feats, mask_out, nbr_idx, weight, f_in, f_out,
                           stride, inv, shift, lane_mask):
    return zwin_conv_epi_cuda(feats, mask_out, nbr_idx, weight, f_in, f_out,
                              stride, inv, shift, lane_mask)


@zwin_conv_epi_op.register_fake
def _zwin_conv_epi_op_fake(feats, mask_out, nbr_idx, weight, f_in, f_out,
                           stride, inv, shift, lane_mask):
    return _zwin_conv_op_fake(feats, mask_out, nbr_idx, weight, f_in, f_out,
                              stride)


class ZwinConv(torch.autograd.Function):
    """Forward: ``zwin_conv_op`` (the plain version for CPU tensors, K3
    otherwise); backward: ``zwin_conv_bwd`` on both.  The saved float
    tensors are the inputs (feats, weight), as JAX's residuals."""

    @staticmethod
    def forward(ctx, feats, mask_out, nbr_idx, weight, f_in, f_out, stride):
        ctx.save_for_backward(feats, mask_out, nbr_idx, weight)
        ctx.geom = (f_in, f_out, stride)
        return zwin_conv_op(feats, mask_out, nbr_idx, weight, f_in, f_out,
                            stride)

    @staticmethod
    def backward(ctx, g):
        feats, mask_out, nbr_idx, weight = ctx.saved_tensors
        d_feats, d_weight = zwin_conv_bwd(feats, mask_out, nbr_idx, weight,
                                          *ctx.geom, g)
        return d_feats, None, None, d_weight, None, None, None


def zwin_conv(feats: torch.Tensor, mask_out: torch.Tensor,
              nbr_idx: torch.Tensor, weight: torch.Tensor,
              f_in: int, f_out: int, stride: int) -> torch.Tensor:
    """``ZwinConv``: the plain version for CPU tensors, the CUDA kernel
    otherwise, differentiable in feats and weight."""
    return ZwinConv.apply(feats, mask_out, nbr_idx, weight, f_in, f_out,
                          stride)


def zwin_conv_epi(feats: torch.Tensor, mask_out: torch.Tensor,
                  nbr_idx: torch.Tensor, weight: torch.Tensor,
                  f_in: int, f_out: int, stride: int, inv: torch.Tensor,
                  shift: torch.Tensor, lane_mask: torch.Tensor
                  ) -> torch.Tensor:
    """The fused conv op: plain version for CPU tensors, the CUDA kernel
    otherwise; never the unfused chain."""
    return zwin_conv_epi_op(feats, mask_out, nbr_idx, weight, f_in, f_out,
                            stride, inv, shift, lane_mask)
