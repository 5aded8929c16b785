"""Swin's block glue around the window attention: the plain version and
the CUDA kernels' wrappers.

A block of ``nn/swin.py`` runs, on tokens x (B, H*W, C):

    wins = to_windows(norm1(x))       pad to whole windows, roll by -shift,
                                      split into (B*nWh*nWw, w*w, C)
    o    = proj(K2(qkv(wins)))        in window order
    x    = x + from_windows(o)        merge, roll by +shift, crop
    x    = x + mlp(norm2(x))

Two custom ops take the memory-bound steps between the products:

- ``fusionocc::window_in`` (``window_in_op``): with r, the previous
  block's MLP output, x' = x + r, then the windows of norm1(x');
- ``fusionocc::window_out`` (``window_out_op``): x' = x + from_windows(o)
  and norm2(x').

Their CPU implementation is the plain version (``window_in_plain``,
``window_out_plain``), the same functions the training composition runs
(``to_windows``, ``from_windows``, ``nn.layers.layer_norm``), so the
mathematics has one definition.  Their CUDA implementation launches
``csrc/swin_glue.cu`` (``window_in_fwd``, ``window_out_fwd``), one pass
each, and never falls back: it rounds where the plain version does (the
residual stream after each add, the normed value once) and differs only in
the order of the fp32 sums of a LayerNorm's statistics.  A padded window
token is zero, as the plain version pads the normed tensor.  The ops have
no gradient: ``nn/swin.py`` takes them only in eval mode with autograd off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.layers import layer_norm
from .kernels import KERNELS, stream_ptr

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def window_grid(H: int, W: int, w: int) -> Tuple[int, int]:
    """(nWh, nWw): windows of w x w over H x W padded to whole windows."""
    return -(-H // w), -(-W // w)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nWh*nWw, w*w, C); H, W divisible by w."""
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(wins: torch.Tensor, w: int, B: int, H: int, W: int
                   ) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.view(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def to_windows(y: torch.Tensor, H: int, W: int, w: int, shift: int
               ) -> torch.Tensor:
    """Tokens (B, H*W, C) -> windows (B*nWh*nWw, w*w, C): zero-padded at
    the bottom and right to whole windows, rolled by -shift on both axes."""
    B, _, C = y.shape
    nWh, nWw = window_grid(H, W, w)
    y = F.pad(y.view(B, H, W, C), (0, 0, 0, nWw * w - W, 0, nWh * w - H))
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    return window_partition(y, w)


def from_windows(wins: torch.Tensor, B: int, H: int, W: int, w: int,
                 shift: int) -> torch.Tensor:
    """``to_windows`` undone: windows -> tokens (B, H*W, C), rolled back by
    +shift and cropped."""
    nWh, nWw = window_grid(H, W, w)
    y = window_reverse(wins, w, B, nWh * w, nWw * w)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y[:, :H, :W].reshape(B, H * W, wins.shape[-1])


def window_in_plain(x, r: Optional[torch.Tensor], weight, bias, eps: float,
                    H: int, W: int, w: int, shift: int):
    """(x + r, or x without r; the windows of its LayerNorm)."""
    if r is not None:
        x = x + r
    return x, to_windows(layer_norm(x, weight, bias, eps), H, W, w, shift)


def window_out_plain(o, x, weight, bias, eps: float, H: int, W: int, w: int,
                     shift: int):
    """(x + from_windows(o), its LayerNorm)."""
    x = x + from_windows(o, x.shape[0], H, W, w, shift)
    return x, layer_norm(x, weight, bias, eps)


def lanes(C: int, itemsize: int) -> int:
    """Lanes a token row of C channels of ``itemsize`` bytes takes in the
    kernels (a power of two up to 32, each lane 1, 2, 4 or 8 16-byte
    vectors of the row); 0 if they take no such row."""
    vecs = C * itemsize // 16 if C * itemsize % 16 == 0 else 0
    return min(vecs, 32) if vecs in (4, 8, 16, 32, 64, 128, 256) else 0


def _check(x, weight, bias, H: int, W: int, w: int, shift: int) -> None:
    _, L, C = x.shape
    if x.device.type != 'cuda':
        raise ValueError(f'the glue kernels need CUDA tensors, got {x.device}')
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f'the glue kernels take float32 or bfloat16, got '
                        f'{x.dtype}')
    if L != H * W or not 0 <= shift < w:
        raise ValueError(f'{L} tokens for a {H}x{W} map, or shift {shift} '
                         f'for window {w}')
    if not lanes(C, x.element_size()):
        raise ValueError(f'the glue kernels take no row of {C} {x.dtype} '
                         'channels (16-byte vectors, 4-8 a row or 32 lanes '
                         'of 1, 2, 4 or 8)')
    for t in (weight, bias):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f'the norm takes ({C},) float32 weight and bias '
                             f'on {x.device}')


def _launch(entry: str, a, b, xo, weight, bias, out, eps: float, H: int,
            W: int, w: int, shift: int, B: int, C: int) -> None:
    if B == 0:          # a rank with no images (the hybrid mesh): no grid
        return
    ptrs = [None if t is None else t.data_ptr()
            for t in (a, b, xo, weight, bias, out)]
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError('the glue kernels need 16-byte aligned tensors')
    with torch.cuda.device(a.device):
        KERNELS.launch(entry, *ptrs, B, H, W, C, w, shift, float(eps),
                       _DTYPE_CODE[a.dtype], stream_ptr(a.device))


def window_in_cuda(x, r: Optional[torch.Tensor], weight, bias, eps: float,
                   H: int, W: int, w: int, shift: int):
    """Launch ``window_in_fwd``: (x + r, or an empty tensor without r; the
    windows (B*nWh*nWw, w*w, C))."""
    _check(x, weight, bias, H, W, w, shift)
    B, _, C = x.shape
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype
                          or r.device != x.device):
        raise ValueError(f'r {tuple(r.shape)} {r.dtype} does not match x '
                         f'{tuple(x.shape)} {x.dtype}')
    x = x.contiguous()
    r = None if r is None else r.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    nWh, nWw = window_grid(H, W, w)
    # new_empty, not empty_like: a tenth of its host time, the same layout
    # for a contiguous x
    wins = x.new_empty(B * nWh * nWw, w * w, C)
    xo = x.new_empty(0 if r is None else x.shape)
    _launch('window_in_fwd', x, r, None if r is None else xo, weight, bias,
            wins, eps, H, W, w, shift, B, C)
    return xo, wins


def window_out_cuda(o, x, weight, bias, eps: float, H: int, W: int, w: int,
                    shift: int):
    """Launch ``window_out_fwd``: (x + from_windows(o), its LayerNorm)."""
    _check(x, weight, bias, H, W, w, shift)
    B, _, C = x.shape
    nWh, nWw = window_grid(H, W, w)
    if o.shape != (B * nWh * nWw, w * w, C) or o.dtype != x.dtype \
            or o.device != x.device:
        raise ValueError(f'o {tuple(o.shape)} {o.dtype} is not the windows '
                         f'of x {tuple(x.shape)} {x.dtype}')
    o, x = o.contiguous(), x.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    xo, h = x.new_empty(x.shape), x.new_empty(x.shape)
    _launch('window_out_fwd', o, x, xo, weight, bias, h, eps, H, W, w, shift,
            B, C)
    return xo, h


@torch.library.custom_op('fusionocc::window_in', mutates_args=(),
                         device_types='cpu')
def window_in_op(x: torch.Tensor, r: Optional[torch.Tensor],
                 weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 H: int, W: int, w: int, shift: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A as a custom op: on the CPU the plain version.  Without r
    the first output is empty (an op's output may not be its input)."""
    x_new, wins = window_in_plain(x, r, weight, bias, eps, H, W, w, shift)
    return (x.new_empty(0) if r is None else x_new), wins


@window_in_op.register_kernel('cuda')
def _window_in_op_cuda(x, r, weight, bias, eps, H, W, w, shift):
    # the wrapper by its module name, so a caller may wrap it
    return window_in_cuda(x, r, weight, bias, eps, H, W, w, shift)


@window_in_op.register_fake
def _window_in_op_fake(x, r, weight, bias, eps, H, W, w, shift):
    B, _, C = x.shape
    nWh, nWw = window_grid(H, W, w)
    return (x.new_empty(0) if r is None else x.new_empty(x.shape),
            x.new_empty(B * nWh * nWw, w * w, C))


@torch.library.custom_op('fusionocc::window_out', mutates_args=(),
                         device_types='cpu')
def window_out_op(o: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, eps: float, H: int, W: int, w: int,
                  shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B as a custom op: on the CPU the plain version."""
    return window_out_plain(o, x, weight, bias, eps, H, W, w, shift)


@window_out_op.register_kernel('cuda')
def _window_out_op_cuda(o, x, weight, bias, eps, H, W, w, shift):
    return window_out_cuda(o, x, weight, bias, eps, H, W, w, shift)


@window_out_op.register_fake
def _window_out_op_fake(o, x, weight, bias, eps, H, W, w, shift):
    return x.new_empty(x.shape), x.new_empty(x.shape)


def window_in(x, r: Optional[torch.Tensor], norm, H: int, W: int, w: int,
              shift: int):
    """(x + r, or x itself without r; the windows of ``norm`` of it)."""
    x_new, wins = window_in_op(x, r, norm.weight, norm.bias, norm.eps, H, W,
                               w, shift)
    return (x if r is None else x_new), wins
