"""Shifted-window attention: the plain version and the CUDA kernel wrapper.

Port of ``fusionocc_tpu/ops/pallas/window_attn.py``.  Both versions
compute, per window and head,

    softmax_fp32(q * scale @ k^T + bias[h] + shift_mask) @ v

with q, k, v of shape (Bn, N, C), heads packed in C, Bn = B * nWh * nWw and
N = w * w; bias is (heads, N, N).  Scores and probabilities stay fp32 (the
kernel's contract); the output has q's dtype.  The shift mask is mmcv's:
-100 between tokens of different regions, which only the last window row and
column have.

``window_attention`` is the autograd ``Function`` ``WindowAttention``
around the custom op ``fusionocc::window_attn`` (``window_attn_op``): its
CPU implementation is the plain version,
its CUDA one launches ``csrc/window_attn.cu``; it never falls back.  The kernel
has two bodies, chosen by dtype: bf16 runs on Hopper's warpgroup products
with q, k, v loaded by TMA through tensor maps over the strided views (N <=
144, 16-byte aligned starts, strides a multiple of 8 elements), fp32 on the
CUDA cores (N <= 1024).  A bf16 input that the Hopper body does not take
raises.  Its backward is JAX's
``_bwd``, the same code on both devices: it saves (q, k, v, bias), recomputes
the fp32 probabilities P with the shift mask and returns dq, dk, dv in the
inputs' dtype and dbias summed over windows.
"""
from __future__ import annotations

import torch

from .kernels import KERNELS, stream_ptr

MASK_VALUE = -100.0  # mmcv's masked_fill value
KERNEL_HEAD_DIM = 32
MAX_N = {torch.float32: 1024, torch.bfloat16: 144}   # tokens per window
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def shift_masks(nWh: int, nWw: int, w: int, shift: int,
                device=None) -> torch.Tensor:
    """(nWh * nWw, N, N) additive masks of the cyclic shift (zeros if 0)."""
    n = w * w
    if shift == 0:
        return torch.zeros(nWh * nWw, n, n, device=device)
    tok = torch.arange(n, device=device)
    win = torch.arange(nWh * nWw, device=device)[:, None]
    # region id per (window, token): only the last window row / column is
    # split, at w - shift
    ry = torch.where(tok // w < w - shift, 1, 2) * (win // nWw == nWh - 1)
    rx = torch.where(tok % w < w - shift, 1, 2) * (win % nWw == nWw - 1)
    rid = ry * 3 + rx                                    # (nW, N)
    same = rid[:, :, None] == rid[:, None, :]
    return torch.where(same, 0.0, MASK_VALUE).float()


def attention_probs(q, k, bias, nWh: int, nWw: int, w: int, shift: int,
                    heads: int) -> torch.Tensor:
    """(Bn, heads, N, N) fp32 softmax(q * scale @ k^T + bias + mask)."""
    bn, n, c = q.shape
    d = c // heads
    qh = q.float().reshape(bn, n, heads, d)
    kh = k.float().reshape(bn, n, heads, d)
    s = torch.einsum('bnhd,bmhd->bhnm', qh * d ** -0.5, kh)
    s = s + bias.float()[None]
    if shift > 0:
        nw = nWh * nWw
        m = shift_masks(nWh, nWw, w, shift, q.device)
        s = (s.view(bn // nw, nw, heads, n, n) + m[None, :, None]
             ).view(bn, heads, n, n)
    return torch.softmax(s, dim=-1)


def window_attention_plain(q, k, v, bias, nWh: int, nWw: int, w: int,
                           shift: int, heads: int) -> torch.Tensor:
    """einsum + fp32 softmax version of the kernel."""
    bn, n, c = q.shape
    p = attention_probs(q, k, bias, nWh, nWw, w, shift, heads)
    vh = v.float().reshape(bn, n, heads, c // heads)
    out = torch.einsum('bhnm,bmhd->bnhd', p, vh)
    return out.reshape(bn, n, c).to(q.dtype)


def window_attention_cuda(q, k, v, bias, nWh: int, nWw: int, w: int,
                          shift: int, heads: int) -> torch.Tensor:
    """Launch ``window_attn_fwd``; q, k, v may be strided column slices."""
    return _launch('window_attn_fwd', q, k, v, bias, nWh, nWw, w, shift,
                   heads)


def _launch(entry: str, q, k, v, bias, nWh: int, nWw: int, w: int,
            shift: int, heads: int) -> torch.Tensor:
    """Check the operands and launch C entry ``entry``."""
    bn, n, c = q.shape
    d = c // heads
    if q.device.type != 'cuda':
        raise ValueError(f'window_attention_cuda needs CUDA tensors, got '
                         f'{q.device}')
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'q, k, v must share dtype float32 or bfloat16, got '
                        f'{q.dtype}, {k.dtype}, {v.dtype}')
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'shape mismatch {q.shape} {k.shape} {v.shape}')
    if (k.stride() != q.stride() or v.stride() != q.stride()
            or q.stride(2) != 1):
        raise ValueError('q, k, v need equal strides and a unit last stride, '
                         f'got {q.stride()} {k.stride()} {v.stride()}')
    if n != w * w or c != heads * d or d != KERNEL_HEAD_DIM:
        raise ValueError(f'kernel takes N = w*w and head_dim '
                         f'{KERNEL_HEAD_DIM}; got N={n}, w={w}, C={c}, '
                         f'heads={heads}')
    if n > MAX_N[q.dtype] or bn % (nWh * nWw) != 0:
        raise ValueError(f'bad window grid for {q.dtype}: N={n} (at most '
                         f'{MAX_N[q.dtype]}), Bn={bn}, nWh={nWh}, nWw={nWw}')
    if q.dtype == torch.bfloat16 and (
            any(t.data_ptr() % 16 for t in (q, k, v))
            or q.stride(0) % 8 or q.stride(1) % 8):
        raise ValueError('the bf16 body loads q, k, v by TMA: they need '
                         '16-byte aligned starts and strides that are '
                         f'multiples of 8, got {q.stride()}')
    if bn * n >= 2 ** 31:
        # the kernel takes window and token ids as int and forms its
        # offsets in int64: only the token count must fit in int32
        raise ValueError(f'{bn} windows of {n} tokens exceed int32')
    bias = bias.float().contiguous()
    if bias.shape != (heads, n, n) or bias.device != q.device:
        raise ValueError(f'bias must be ({heads}, {n}, {n}) on {q.device}')
    out = torch.empty((bn, n, c), dtype=q.dtype, device=q.device)
    if bn == 0:         # a rank with no images (the hybrid mesh): no grid
        return out
    with torch.cuda.device(q.device):
        KERNELS.launch(
            entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), bn, n, c, heads, d, q.stride(0),
            q.stride(1), nWh, nWw, w, shift, d ** -0.5, _DTYPE_CODE[q.dtype],
            stream_ptr(q.device))
    return out


def window_attention_bwd(q, k, v, bias, nWh: int, nWw: int, w: int,
                         shift: int, heads: int, g: torch.Tensor):
    """JAX's ``_bwd``: (dq, dk, dv) in the inputs' dtype and dbias (heads,
    N, N) in bias's, from the recomputed fp32 probabilities."""
    bn, n, c = q.shape
    d = c // heads
    scale = d ** -0.5
    p = attention_probs(q, k, bias, nWh, nWw, w, shift, heads)
    gf = g.float().reshape(bn, n, heads, d)
    vh = v.float().reshape(bn, n, heads, d)
    qh = q.float().reshape(bn, n, heads, d)
    kh = k.float().reshape(bn, n, heads, d)
    dv = torch.einsum('bhnm,bnhd->bmhd', p, gf)
    dp = torch.einsum('bnhd,bmhd->bhnm', gf, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum('bhnm,bmhd->bnhd', ds, kh) * scale
    dk = torch.einsum('bhnm,bnhd->bmhd', ds, qh * scale)
    return (dq.reshape(bn, n, c).to(q.dtype), dk.reshape(bn, n, c).to(k.dtype),
            dv.reshape(bn, n, c).to(v.dtype), ds.sum(dim=0).to(bias.dtype))


@torch.library.custom_op('fusionocc::window_attn', mutates_args=(),
                         device_types='cpu')
def window_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, nWh: int, nWw: int, w: int,
                   shift: int, heads: int) -> torch.Tensor:
    """K2 as a custom op: on the CPU the plain version."""
    return window_attention_plain(q, k, v, bias, nWh, nWw, w, shift, heads)


@window_attn_op.register_kernel('cuda')
def _window_attn_op_cuda(q, k, v, bias, nWh, nWw, w, shift, heads):
    # the wrapper by its module name, so a caller may wrap it
    return window_attention_cuda(q, k, v, bias, nWh, nWw, w, shift, heads)


@window_attn_op.register_fake
def _window_attn_op_fake(q, k, v, bias, nWh, nWw, w, shift, heads):
    return q.new_empty(q.shape)


class WindowAttention(torch.autograd.Function):
    """Forward: ``window_attn_op`` (the plain version for CPU tensors, K2
    otherwise); backward: ``window_attention_bwd`` on both."""

    @staticmethod
    def forward(ctx, q, k, v, bias, nWh, nWw, w, shift, heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.geom = (nWh, nWw, w, shift, heads)
        return window_attn_op(q, k, v, bias, nWh, nWw, w, shift, heads)

    @staticmethod
    def backward(ctx, g):
        grads = window_attention_bwd(*ctx.saved_tensors, *ctx.geom, g)
        return grads + (None,) * 5


def window_attention(q, k, v, bias, nWh: int, nWw: int, w: int, shift: int,
                     heads: int) -> torch.Tensor:
    """``WindowAttention``: the plain version for CPU tensors, the CUDA
    kernel otherwise, differentiable in q, k, v and bias."""
    return WindowAttention.apply(q, k, v, bias, nWh, nWw, w, shift, heads)
