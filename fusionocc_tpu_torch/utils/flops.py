"""FLOP counts of the port's paths, the kernels' work included.

``torch.utils.flop_counter.FlopCounterMode`` counts the products of aten's
matmuls and convolutions (2 per multiply-add) and nothing of an op it has
no formula for.  The kernels are custom ops, so this module registers a
formula for each, the products the kernel computes (``chip_smoke.py``
phase 3 bounds K1-K3 by the same count):

- ``fusionocc::window_attn`` (K2): q·kᵀ and p·v, 4·Bn·heads·N²·d;
- ``fusionocc::bev_pool`` (K1): one multiply-add per point in the grid and
  channel, 2·P·C, P = ``bounds[-1]``;
- ``fusionocc::zwin_conv`` (K3) and ``fusionocc::zwin_conv_epi`` (K3 with
  its fused eval epilogue): per active output row, per tap the neighbour
  map finds, per (zo, dz) pair of the tap's z band (``band_pairs``),
  Cin·Cout multiply-adds, times 2.  The epilogue's affine is no product;
- ``fusionocc::plane_sweep`` (BEVStereo4D-Occ's cost volume): per
  hypothesis and channel the bilinear sample's 4 multiplies and 3 adds, a
  difference, an absolute value and an add, 10·C·BN·D·h·w, the benchmark's
  frozen count (``benchmark/reference/bevstereo_occ.plane_sweep_flops``).

K1's and K3's counts depend on the data (the index's bounds, the
neighbour map and the output mask): their formulas read the tensors
(``get_raw=True``), so they cannot count on meta or fake tensors (under
``FakeTensorMode`` or while ``torch.export`` traces).

Each kernel is counted once: the counting mode stops at the custom op, so
the plain version that implements it on the CPU is not counted again, and
an ``autograd.Function``'s backward, which is Python, counts as the aten
ops it runs.  JAX's figure (XLA's cost analysis) leaves the kernels out:
it cannot see inside a ``pallas_call``.
"""
from __future__ import annotations

import copy
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# the ops modules register the fusionocc:: custom ops
from ..ops import bev_pool, plane_sweep, window_attn, zwin_conv  # noqa: F401

# the kernels' ops by the name ``count_flops`` reports them under
KERNEL_OPS = {'window_attn': torch.ops.fusionocc.window_attn,
              'bev_pool': torch.ops.fusionocc.bev_pool,
              'zwin_conv': torch.ops.fusionocc.zwin_conv,
              'zwin_conv_epi': torch.ops.fusionocc.zwin_conv_epi,
              'plane_sweep': torch.ops.fusionocc.plane_sweep}
MODES = ('predict', 'streaming', 'train')


@register_flop_formula(torch.ops.fusionocc.window_attn)
def _window_attn_formula(q_shape, k_shape, v_shape, bias_shape, nWh, nWw, w,
                         shift, heads, out_shape=None) -> int:
    bn, n, c = q_shape
    return 4 * bn * heads * n * n * (c // heads)


@register_flop_formula(torch.ops.fusionocc.bev_pool, get_raw=True)
def _bev_pool_formula(depth_flat, feat_flat, ranks_depth, ranks_feat,
                      ranks_bev, bounds, long_voxels, num_voxels, max_short,
                      out_dtype, out_val=None) -> int:
    return 2 * int(bounds[-1]) * feat_flat.shape[1]


@register_flop_formula((torch.ops.fusionocc.zwin_conv,
                        torch.ops.fusionocc.zwin_conv_epi), get_raw=True)
def _zwin_conv_formula(feats, mask_out, nbr_idx, weight, f_in, f_out, stride,
                       *epilogue, out_val=None) -> int:
    found = ((nbr_idx < feats.shape[1]) & mask_out[..., None]).sum(
        dim=(0, 1)).tolist()
    return 2 * weight.shape[1] * weight.shape[2] * sum(
        found[t] * len(zwin_conv.band_pairs(f_in, f_out, stride, t % 3))
        for t in range(27))


@register_flop_formula(torch.ops.fusionocc.plane_sweep)
def _plane_sweep_formula(prev_shape, curr_shape, frustum_shape, cams_shape,
                         hi, wi, group_size, bias, out_shape=None) -> int:
    BN, h, w, C = curr_shape
    return 10 * C * BN * frustum_shape[0] * h * w


def counted(run) -> Dict:
    """``run()`` under ``FlopCounterMode``: {'total', 'kernels' (each
    kernel op's FLOPs by ``KERNEL_OPS`` name), 'outside' (the rest, the
    figure comparable to XLA's), 'by_op' (every counted op by name)}."""
    with FlopCounterMode(display=False) as counter:
        run()
    by_op = counter.get_flop_counts()['Global']
    kernels = {name: int(by_op.get(op, 0)) for name, op in KERNEL_OPS.items()}
    total = int(counter.get_total_flops())
    return {'total': total, 'kernels': kernels,
            'outside': total - sum(kernels.values()),
            'by_op': {str(op): int(n) for op, n in by_op.items()}}


def count_flops(model, batch, mode: str = 'predict', train_config=None
                ) -> Dict:
    """FLOPs of one call of a path of ``model`` (a ``FusionOcc``, or a
    model of another preset on its path, ``configs.build_model``) on
    ``batch``, as ``counted`` returns them: 'predict' the two-pass
    ``predict`` (pooling indices built in the call), 'streaming' one
    ``predict_streaming`` frame from an empty cache, 'train' one
    ``train_step`` (forward, backward and optimizer; ``train_config`` a
    ``TrainConfig``) on a copy of the model, which stays as it is.  Runs
    on the model's device, with real tensors."""
    if mode == 'predict':
        return counted(lambda: model.predict(batch))
    if mode == 'streaming':
        state = model.init_streaming_state(batch.imgs.shape[0])
        return counted(lambda: model.predict_streaming(batch, state))
    if mode == 'train':
        from ..train import loop
        if train_config is None:
            raise ValueError("mode 'train' needs a train_config")
        model = copy.deepcopy(model)
        state = loop.create_train_state(model, train_config)
        return counted(lambda: loop.train_step(model, train_config, state,
                                               batch))
    raise ValueError(f'mode must be one of {MODES}, got {mode!r}')
