"""Shifted-window attention, plain PyTorch (the reference of K2).

Per window and head: softmax_fp32(q * scale @ k^T + bias[h] + shift_mask)
@ v, q, k, v (Bn, N, C) with heads packed in C, bias (heads, N, N); the
shift mask is mmcv's (-100 between tokens of different regions).  Autograd
differentiates it.  Frozen copy of the port's plain version.
"""
from __future__ import annotations

import torch

MASK_VALUE = -100.0  # mmcv's masked_fill value


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


def window_attention(q, k, v, bias, nWh: int, nWw: int, w: int, shift: int,
                     heads: int) -> torch.Tensor:
    return window_attention_plain(q, k, v, bias, nWh, nWw, w, shift, heads)
