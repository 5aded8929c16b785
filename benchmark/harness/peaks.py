"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit) and the frozen formulas of the port's kernels.

A kernel's bound is the larger of its FLOPs over the peak rate of its
dtype and its bytes (each input read once, each output written once) over
the memory rate; its roofline share is that bound over the device time it
took.  The formulas take the arguments of the kernel's op as the port
calls it (``fusionocc::window_attn``, ``fusionocc::zwin_conv``,
``fusionocc::zwin_conv_epi``, ``fusionocc::bev_pool``); the data-dependent
counts (K3's found neighbours, K1's points in the grid) are read from them.
"""
from __future__ import annotations

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def window_attn(q, k, v, bias, nWh, nWw, w, shift, heads, out):
    """K2: q·kᵀ and p·v, 4·Bn·heads·N²·d; q, k, v, bias read, out written."""
    bn, n, c = q.shape
    flops = 4 * bn * heads * n * n * (c // heads)
    return flops, 3 * nbytes(q) + nbytes(bias) + nbytes(out), q.dtype


def zwin_conv(feats, mask_out, nbr_idx, weight, f_in, f_out, stride, *rest,
              out=None):
    """K3 (and K3 with its epilogue): per active output row, per tap the
    map finds, per (zo, dz) pair of the tap's z band, Cin·Cout
    multiply-adds; feats, map, mask, weight (and the epilogue's operands)
    read, out written."""
    found = ((nbr_idx < feats.shape[1]) & mask_out[..., None]).sum(
        dim=(0, 1)).tolist()
    pairs = [sum(1 for zo in range(f_out) for dz in range(3)
                 if (stride * zo + dz - 1) // f_in + 1 == ds)
             for ds in range(3)]
    flops = 2 * weight.shape[1] * weight.shape[2] * sum(
        found[t] * pairs[t % 3] for t in range(27))
    read = sum(nbytes(t) for t in (feats, mask_out, nbr_idx, weight) + rest)
    return flops, read + nbytes(out), feats.dtype


def bev_pool(depth_flat, feat_flat, ranks_depth, ranks_feat, ranks_bev,
             bounds, long_voxels, num_voxels, max_short, out_dtype, out):
    """K1: one multiply-add per point in the grid and channel; the points'
    depth and feature rows, their ranks and the run bounds read, out
    written."""
    inside = int(bounds[-1])
    C = feat_flat.shape[1]
    read = inside * (depth_flat.element_size() + C * feat_flat.element_size()
                     + 3 * 4) + nbytes(bounds)
    return 2 * inside * C, read + nbytes(out), feat_flat.dtype


FORMULAS = {'window_attn': window_attn, 'zwin_conv': zwin_conv,
            'zwin_conv_epi': zwin_conv, 'bev_pool': bev_pool}


def bound_s(flops: float, nbytes_: float, dtype) -> float:
    return max(flops / PEAK_FLOPS.get(dtype, PEAK_BF16), nbytes_ / PEAK_BYTES)


def roofline_share(data, ops):
    """A kernel op's share (%) of its roofline over the profiled units: the
    summed bounds of its calls (replayed under ``trace.OpRecorder``) over
    the device time the profiler attributed to the op; None when the path
    made no call."""
    calls = [c for op in ops for c in data.op_calls.get(op, [])]
    dev = sum(data.op_device_s.get(op, 0.0) for op in ops)
    if not calls or dev <= 0:
        return None
    bound = sum(bound_s(f, b, getattr(torch, dt.split('.')[-1]))
                for f, b, dt in calls)
    return 100.0 * bound / dev
