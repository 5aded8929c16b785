"""Core building blocks, named as the reference's mmdet3d modules.

Port of ``fusionocc_tpu/nn/layers.py``.  Attribute names follow the
reference checkpoint (mmcv ConvModule ``conv``/``bn``, mmdet BasicBlock
``conv1``/``bn1``/``conv2``/``bn2``, Sequential indices), so a reference
``state_dict`` loads directly.

Precision follows the JAX package: parameters stay float32; ``Linear`` and
``Conv*`` cast them to the input's dtype and compute in it (bfloat16 at full
size); ``LayerNorm`` and ``BatchNorm`` compute in float32 and return the
input's dtype.  Tensors are NCHW / NCDHW inside these modules.

Training follows the module's ``training`` flag.  The BatchNorms then
normalise with batch statistics and update their running statistics with
flax's rule (the biased batch variance; torch's ``momentum`` is 1 - flax's).
Random draws (``dropout``, ``drop_path`` masks, the depth-input drop) come
from the generator of the enclosing ``random_scope``; ``checkpoint`` runs a
function under ``torch.utils.checkpoint`` without updating running
statistics again in the recompute.

Inside a process group (``parallel.mesh.data_mesh()``) training is over the
global batch, as the JAX package's data mesh makes it: the BatchNorms sum
their statistics over every rank, and each random mask is drawn at the
global batch's shape, each rank keeping its rows.  Under the hybrid mesh a
module that every spatial rank runs on the same samples (the LiDAR
encoder, ``pre_process_net``) sums its statistics over the data group
only (``HybridMesh.replicated``), so no sample counts twice.
"""
from __future__ import annotations

import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel import mesh

# the generator of the enclosing random_scope, and whether BatchNorms leave
# their running statistics alone (a checkpoint's recompute, which runs in
# the autograd engine's thread)
_GENERATOR = contextvars.ContextVar('generator', default=None)
_FREEZE_STATS = contextvars.ContextVar('freeze_stats', default=False)


def random_scope(generator: torch.Generator):
    """Training draws inside the ``with`` block come from ``generator``."""
    return mesh.setting(_GENERATOR, generator)


def keep_mask(shape, rate: float, device, batch_axis: int = 0
              ) -> torch.Tensor:
    """A bool mask, each entry True with probability 1 - rate, drawn from
    the scope's generator (which must live on ``device``).  Inside a
    process group of R ranks the mask is drawn at the global shape (axis
    ``batch_axis`` R times as long) and this rank's block of that axis is
    returned, so R ranks draw what one process at the global batch
    draws; under the hybrid mesh the block is this rank's camera images
    of the global batch's (``parallel.mesh.draw_block``)."""
    g = _GENERATOR.get()
    if g is None:
        raise RuntimeError('a random draw in training needs a generator: '
                           'run the forward inside random_scope(generator)')
    if g.device.type != torch.device(device).type:
        raise ValueError(f'the generator is on {g.device}, the tensor on '
                         f'{device}')
    shape = list(shape)
    local = shape[batch_axis]
    start, shape[batch_axis] = mesh.draw_block(local)
    keep = torch.rand(shape, generator=g, device=device) < 1.0 - rate
    return keep.narrow(batch_axis, start, local)


def dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Elementwise dropout: x / (1 - rate) where kept, else 0 (flax's
    ``nn.Dropout``)."""
    return torch.where(keep_mask(x.shape, rate, x.device), x / (1.0 - rate),
                       0)


def drop_path(x: torch.Tensor, keep: torch.Tensor, rate: float
              ) -> torch.Tensor:
    """Stochastic depth with a per-sample mask ``keep`` (B,) drawn
    beforehand (``keep_mask((B,), rate, ...)``): x / (1 - rate) for kept
    samples, else 0."""
    keep = keep.view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x / (1.0 - rate), 0)


def checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant).  The
    recompute in the backward leaves the BatchNorms' running statistics
    alone, as JAX's ``remat`` does (flax's mutable state is written once);
    it draws nothing, so ``fn``'s random masks must come in ``args``."""
    calls = []

    def run(*a):
        if calls:
            with mesh.setting(_FREEZE_STATS, True):
                return fn(*a)
        calls.append(1)
        return fn(*a)
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype.  With ``int8`` set (the
    Swin layers of ``SwinConfig.int8_dense``) the product runs through
    ``quant.int8_linear`` on the weight cast to that dtype, and the bias is
    added after, in that dtype, as flax's ``Dense`` with JAX's
    ``int8_dot_general`` does."""

    int8 = False

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if not self.int8:
            return F.linear(x, w, _cast(self.bias, x.dtype))
        from ..quant import int8_linear
        y = int8_linear(x, w)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """nn.Conv3d computing in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last axis in float32, returned in x's dtype."""
    return F.layer_norm(x.float(), weight.shape, weight, bias, eps
                        ).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``layer_norm``, eps 1e-6 (flax's default, which the JAX package
    keeps; torch and mmcv use 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over axis 1 (any rank), eps 1e-5, in float32.

    In eval mode it normalises with the running statistics.  In training
    it normalises with the batch's and then updates the running ones as
    flax does: ``r = (1 - momentum) * r + momentum * batch`` with the
    *biased* batch variance (torch would take the unbiased one); momentum
    0.1 is flax's 0.9.  Inside a process group the batch statistics are
    those of every rank's rows: the sums and the count all-reduced, then
    the sum of squared deviations from that mean (two passes); every rank
    then holds the same running statistics.  Keeps
    ``num_batches_tracked`` so reference checkpoints load.  Built in eval
    mode, as the port's entry points are; ``train()`` switches it.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.eval()

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'BatchNorm expects (N, C, ...), got {x.shape}')

    def forward(self, x):
        self._check_input_dim(x)
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        # JAX's normalisation, (x - mean) * (rsqrt(var + eps) * scale) +
        # bias, differentiated by autograd: torch's fused training
        # backward rounds differently where the input gradient is a small
        # difference of large sums
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        group = mesh.stats_group()
        if group is None:
            var, mean = torch.var_mean(xf, dim=dims, correction=0,
                                       keepdim=True)
        else:       # over every rank's rows, two passes
            count = xf.new_full((1,), xf.numel() // xf.shape[1])
            sums = mesh.all_reduce_sum(torch.cat([xf.sum(dim=dims), count]),
                                       'bn', group)
            mean = (sums[:-1] / sums[-1]).view(shape)
            var = (mesh.all_reduce_sum((xf - mean).square().sum(dim=dims),
                                       'bn', group) / sums[-1]).view(shape)
        self.update_stats(mean.detach().flatten(), var.detach().flatten())
        inv = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return ((xf - mean) * inv + self.bias.view(shape)).to(x.dtype)

    @torch.no_grad()
    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold a batch's mean and biased variance into the running
        statistics, except in a checkpoint's recompute."""
        if _FREEZE_STATS.get():
            return
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm of sparse voxel features, eps 1e-3 (spconv's BN1d in the
    reference's LiDAR encoder; not torch's 1e-5).

    Two layouts share the (C,) parameters: z-folded lanes, x (..., F*C)
    with the cell lane mask (..., F); and cells, x (..., C) with the cell
    mask (...).  In eval mode y = (x * inv + shift) * mask in float32, then
    cast to x's dtype, with the per-channel affine of ``scale_shift()``
    (``affine`` is torch's bool attribute of a BatchNorm).  In training the
    mean and biased variance are taken over the active cells only (the F*C
    lanes collapse to C channels; the count is the number of active cells,
    of every rank inside a process group),
    y = ((x - mean) * inv + bias) * mask, and the running statistics move
    with flax's momentum 0.99 (torch's 0.01).
    """

    def __init__(self, c: int):
        super().__init__(c, eps=1e-3, momentum=0.01)

    def scale_shift(self):
        """(inv, shift), (C,) float32, with eval BN(x) = x * inv + shift:
        inv = weight * rsqrt(var + eps), shift = bias - mean * inv (JAX's
        ``MaskedBatchNorm`` queried with ``x=None``, the fused zwin
        epilogue's operands)."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x, mask):
        C = self.num_features
        if mask.dim() == x.dim():       # lane mask (..., F) of (..., F*C)
            fold = x.shape[-1] // C
            m = mask.float().repeat_interleave(C, dim=-1)
        else:
            fold, m = 1, mask.float()[..., None]
        if not self.training:
            inv, shift = self.scale_shift()
            y = (x.float() * inv.repeat(fold) + shift.repeat(fold)) * m
            return y.to(x.dtype)

        def channel_sum(v):             # (..., fold*C) -> (C,)
            return v.reshape(-1, fold, C).sum(dim=(0, 1))
        xf = x.float()
        # the active cells of every rank in a process group
        group = mesh.stats_group()
        sums = mesh.all_reduce_sum(
            torch.cat([channel_sum(xf * m), mask.float().sum().view(1)]), 'bn',
            group)
        cnt = sums[-1].clamp_min(1.0)
        mean = sums[:-1] / cnt
        centred = xf - mean.repeat(fold)
        var = mesh.all_reduce_sum(channel_sum(centred.square() * m),
                                  'bn', group) / cnt
        self.update_stats(mean.detach(), var.detach())
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (centred * inv.repeat(fold) + self.bias.repeat(fold)) * m
        return y.to(x.dtype)


def conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    """Sequential(3x3 conv, bn, relu): keys ``0.weight``, ``1.*``."""
    return nn.Sequential(Conv2d(cin, cout, 3, 1, 1, bias=False),
                         BatchNorm(cout), nn.ReLU())


class ConvBN(nn.Module):
    """mmcv ConvModule with Conv3d: ``conv`` (no bias) + ``bn`` + optional
    ReLU, symmetric padding ``k // 2``.  (The slice's 2D ConvModules are
    Sequential-named in the reference: ``conv_bn_relu``.)"""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv3d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.act else y


class BasicBlock2D(nn.Module):
    """mmdet BasicBlock: two 3x3 conv+BN, residual, ReLU.  ``c`` in
    channels, ``planes`` out (``c`` by default); the residual is the input,
    or the given ``downsample`` module of it (key ``downsample``)."""

    def __init__(self, c: int, planes: int = 0,
                 downsample: nn.Module = None):
        super().__init__()
        planes = planes or c
        self.conv1 = Conv2d(c, planes, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


class BasicBlock3D(nn.Module):
    """3D residual block: ``conv1`` (3x3x3, stride, ReLU), ``conv2`` (3x3x3),
    optional ``downsample`` ConvModule on the identity, then add + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride, act=True)
        self.conv2 = ConvBN(cout, cout, 3, 1, act=False)
        self.downsample = (ConvBN(cin, cout, 3, stride, act=False)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class SELayer(nn.Module):
    """Camera-aware squeeze-excite: x * sigmoid(expand(relu(reduce(x_se))))."""

    def __init__(self, c: int):
        super().__init__()
        self.conv_reduce = Conv2d(c, c, 1, bias=True)
        self.conv_expand = Conv2d(c, c, 1, bias=True)

    def forward(self, x, x_se):
        g = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(g)


class Mlp(nn.Module):
    """Linear-ReLU-Linear."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(cin, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class _AsppModule(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, dilation: int):
        super().__init__()
        self.atrous_conv = Conv2d(cin, cout, k, 1, 0 if k == 1 else dilation,
                                  dilation=dilation, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: dilations 1/6/12/18 and a global
    average branch, concatenated, then 1x1 conv + BN + ReLU, and in
    training ``dropout(0.5)``."""

    def __init__(self, cin: int, mid: int):
        super().__init__()
        self.aspp1 = _AsppModule(cin, mid, 1, 1)
        self.aspp2 = _AsppModule(cin, mid, 3, 6)
        self.aspp3 = _AsppModule(cin, mid, 3, 12)
        self.aspp4 = _AsppModule(cin, mid, 3, 18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)), Conv2d(cin, mid, 1, bias=False),
            BatchNorm(mid), nn.ReLU())
        self.conv1 = Conv2d(mid * 5, cin, 1, bias=False)
        self.bn1 = BatchNorm(cin)

    def forward(self, x):
        x4 = self.aspp4(x)
        g = self.global_avg_pool(x).expand(-1, -1, *x4.shape[2:])
        y = torch.cat([self.aspp1(x), self.aspp2(x), self.aspp3(x), x4, g], 1)
        y = F.relu(self.bn1(self.conv1(y)))
        return dropout(y, 0.5) if self.training else y
