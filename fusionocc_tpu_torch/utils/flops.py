"""FLOP counts of the port's paths, the kernels' work included.

``torch.utils.flop_counter.FlopCounterMode`` counts the products of aten's
matmuls and convolutions (2 per multiply-add) and nothing of an op it has
no formula for.  The four kernels are custom ops, so this module registers
a formula for each, the products the kernel computes (``chip_smoke.py``
phase 3 bounds each kernel by the same count):

- ``fusionocc::window_attn`` (K2): q·kᵀ and p·v, 4·Bn·heads·N²·d;
- ``fusionocc::bev_pool`` (K1): one multiply-add per point in the grid and
  channel, 2·P·C, P = ``bounds[-1]``;
- ``fusionocc::zwin_conv`` (K3) and ``fusionocc::zwin_conv_epi`` (K3 with
  its fused eval epilogue): per active output row, per tap the neighbour
  map finds, per (zo, dz) pair of the tap's z band (``band_pairs``),
  Cin·Cout multiply-adds, times 2.  The epilogue's affine is no product.

BEVStereo4D-Occ's plane sweep (``models/bevstereo_occ.CostVolume``) is
plain PyTorch whose grid samples the counting mode has no formula for;
``count_flops`` adds the frozen count of each of its calls (forward hooks):
per hypothesis and channel the bilinear sample's 4 multiplies and 3 adds,
a difference, an absolute value and an add, 10·C·BN·D·h·w, the
benchmark's count (``benchmark/reference/bevstereo_occ.plane_sweep_flops``).

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

from ..models.bevstereo_occ import CostVolume
# the ops modules register the fusionocc:: custom ops
from ..ops import bev_pool, window_attn, zwin_conv  # noqa: F401

# the kernels' ops by the name ``count_flops`` reports them under
KERNEL_OPS = {'window_attn': torch.ops.fusionocc.window_attn,
              'bev_pool': torch.ops.fusionocc.bev_pool,
              'zwin_conv': torch.ops.fusionocc.zwin_conv,
              'zwin_conv_epi': torch.ops.fusionocc.zwin_conv_epi}
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


def plane_sweep_flops(curr: torch.Tensor, depth_bins: int) -> int:
    """The frozen count of one plane sweep on the stage-0 feature ``curr``
    (BN, h, w, C): 10·C·BN·D·h·w."""
    BN, h, w, C = curr.shape
    return 10 * C * BN * depth_bins * h * w


def counted(run, model=None) -> Dict:
    """``run()`` under ``FlopCounterMode``: {'total', 'kernels' (each
    kernel op's FLOPs by ``KERNEL_OPS`` name, and ``plane_sweep``, the
    frozen count of ``model``'s cost volumes), 'outside' (the rest, the
    figure comparable to XLA's), 'by_op' (every counted op by name)}."""
    sweeps = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: sweeps.append(
            plane_sweep_flops(args[0], mod.depth_bins)))
        for m in (model.modules() if model is not None else ())
        if isinstance(m, CostVolume)]
    try:
        with FlopCounterMode(display=False) as counter:
            run()
    finally:
        for h in hooks:
            h.remove()
    by_op = counter.get_flop_counts()['Global']
    kernels = {name: int(by_op.get(op, 0)) for name, op in KERNEL_OPS.items()}
    total = int(counter.get_total_flops())
    if hooks:
        kernels['plane_sweep'] = sum(sweeps)
        total += kernels['plane_sweep']
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
        return counted(lambda: model.predict(batch), model)
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
