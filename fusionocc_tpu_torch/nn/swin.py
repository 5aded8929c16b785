"""Swin Transformer backbone, named as mmcv's (reference checkpoint keys).

Port of ``fusionocc_tpu/nn/swin.py``: patch embed (4x4 conv) + LayerNorm,
four stages of shifted-window blocks, mmcv unfold-order PatchMerging between
stages, per-out-index LayerNorms, and ``return_stereo_feat`` (stage 0's
output first).  Every block's attention goes through
``ops.window_attn.window_attention`` (the CUDA kernel for CUDA tensors, in
an autograd ``Function``).  Public layout is NHWC; tokens are (B, L, C).

In eval mode with autograd off (every ``predict*``) a stage's blocks run
their glue through the two ops of ``ops/swin_glue.py``: ``window_in``
(the previous block's MLP residual add, norm1, pad, shift, window split)
and ``window_out`` (window merge, unshift, crop, the attention's residual
add, norm2), which launch ``csrc/swin_glue.cu`` for CUDA tensors; the
stage's last MLP residual is a plain add.  Otherwise (training, and eval
with autograd on) each block composes the ops' plain functions, so both
paths compute the same mathematics.

In training, block i drops its two residual branches per sample with rate
``linspace(0, drop_path_rate, sum(depths))[i]`` (JAX's rates), and
``with_cp`` runs each block under ``nn.layers.checkpoint``.  The masks are
drawn before the checkpointed call and passed in: the checkpoint restores
the RNG state of torch's default generators only, not of the generator the
draws come from, so a mask drawn inside would differ in the recompute.

With ``int8_dense`` every Linear of the backbone (``qkv``, ``proj``, the
ffn's two layers and the patch-merge ``reduction``) runs through
``quant.int8_linear`` (int8 serving, JAX's ``int8_dot_general``); the
attention itself stays K2, fed by the int8 ``qkv``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import SwinConfig
from ..ops import swin_glue
from ..ops.swin_glue import from_windows, to_windows, window_grid
from ..ops.window_attn import window_attention
from .layers import (Conv2d, LayerNorm, Linear, checkpoint, drop_path,
                     keep_mask)


def relative_position_index(w: int) -> torch.Tensor:
    """(w*w, w*w) index into the (2w-1)^2-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return torch.from_numpy(rel.sum(-1))


class WindowMSA(nn.Module):
    """Multi-head attention within windows with relative position bias."""

    def __init__(self, dim: int, num_heads: int, w: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.w = num_heads, w
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * w - 1) ** 2, num_heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(w))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x, nWh: int, nWw: int, shift: int):
        _, N, C = x.shape
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        bias = bias.view(N, N, self.num_heads).permute(2, 0, 1).float()
        qkv = self.qkv(x)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        out = window_attention(q, k, v, bias.contiguous(), nWh, nWw, self.w,
                               shift, self.num_heads)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """Pad to whole windows, cyclic shift, windowed attention, undo both."""

    def __init__(self, dim: int, num_heads: int, w: int, shift: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.w, self.shift = w, shift
        self.w_msa = WindowMSA(dim, num_heads, w, qkv_bias)

    def forward(self, x, hw: Tuple[int, int]):
        H, W = hw
        w, shift = self.w, self.shift
        wins = self.w_msa(to_windows(x, H, W, w, shift),
                          *window_grid(H, W, w), shift)
        return from_windows(wins, x.shape[0], H, W, w, shift)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, w: int, shift: bool,
                 mlp_ratio: int, qkv_bias: bool, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = ShiftWindowMSA(dim, num_heads, w, w // 2 if shift else 0,
                                   qkv_bias)
        self.norm2 = LayerNorm(dim)
        hidden = mlp_ratio * dim
        self.ffn = nn.Module()
        self.ffn.layers = nn.ModuleList([
            nn.Sequential(Linear(dim, hidden), nn.GELU()),
            Linear(hidden, dim)])

    def forward(self, x, hw, keep=None):
        """keep: None, or (2, B) bool masks of the attention and MLP
        branches (stochastic depth)."""
        y = self.attn(self.norm1(x), hw)
        if keep is not None:
            y = drop_path(y, keep[0], self.drop_path_rate)
        x = x + y
        y = self.ffn.layers[1](self.ffn.layers[0](self.norm2(x)))
        if keep is not None:
            y = drop_path(y, keep[1], self.drop_path_rate)
        return x + y

    def infer(self, x, r, hw):
        """The block in eval mode without autograd, through the glue ops:
        tokens x and the previous block's MLP output r (or None) -> (x +
        r + attention, this block's MLP output, not yet added)."""
        H, W = hw
        w, shift = self.attn.w, self.attn.shift
        x, wins = swin_glue.window_in(x, r, self.norm1, H, W, w, shift)
        o = self.attn.w_msa(wins, *window_grid(H, W, w), shift)
        n2 = self.norm2
        x, y = swin_glue.window_out_op(o, x, n2.weight, n2.bias, n2.eps, H, W,
                                       w, shift)
        return x, self.ffn.layers[1](self.ffn.layers[0](y))


class PatchMerging(nn.Module):
    """mmcv unfold-order 2x2 merge (channel c*4 + p, p = ky*2 + kx), then
    LayerNorm(4C) and a bias-free Linear."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = LayerNorm(4 * cin)
        self.reduction = Linear(4 * cin, cout, bias=False)

    def forward(self, x, hw):
        H, W = hw
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        parts = torch.stack([x[:, 0::2, 0::2], x[:, 0::2, 1::2],
                             x[:, 1::2, 0::2], x[:, 1::2, 1::2]], dim=-1)
        Ho, Wo = parts.shape[1], parts.shape[2]
        merged = parts.reshape(B, Ho * Wo, C * 4)
        return self.reduction(self.norm(merged)), (Ho, Wo)


class SwinStage(nn.Module):
    def __init__(self, blocks: List[SwinBlock], downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """(B, H, W, 3) -> [stage-0 feature if return_stereo_feat] + normed
    ``out_indices`` features, each (B, h, w, C).  Built in eval mode."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        dims = cfg.num_features
        p = cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.projection = Conv2d(3, cfg.embed_dims, p, p)
        self.patch_embed.norm = LayerNorm(cfg.embed_dims)
        n = len(cfg.depths)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        first = np.cumsum((0,) + tuple(cfg.depths))
        self.stages = nn.ModuleList([
            SwinStage([SwinBlock(dims[i], cfg.num_heads[i], cfg.window_size,
                                 j % 2 == 1, cfg.mlp_ratio, cfg.qkv_bias,
                                 float(dpr[first[i] + j]))
                       for j in range(cfg.depths[i])],
                      PatchMerging(dims[i], dims[i + 1]) if i < n - 1
                      else None)
            for i in range(n)])
        for i in cfg.out_indices:
            self.add_module(f'norm{i}', LayerNorm(dims[i]))
        if cfg.int8_dense:      # qkv, proj, ffn fc1/fc2, patch-merge reduction
            for mod in self.modules():
                if isinstance(mod, Linear):
                    mod.int8 = True
        self.eval()     # inference semantics until train() is called

    def _embed(self, x):
        """(B, H, W, 3) -> the patch embedding's tokens (B, L, C), (h, w)."""
        x = self.patch_embed.projection(x.permute(0, 3, 1, 2))
        hw = (x.shape[2], x.shape[3])
        return self.patch_embed.norm(x.flatten(2).transpose(1, 2)), hw

    def _stage_blocks(self, stage: SwinStage, x, hw):
        """``stage``'s blocks (not its patch merge) on tokens x (B, L, C)."""
        if not self.training and not torch.is_grad_enabled():
            r = None
            for blk in stage.blocks:
                x, r = blk.infer(x, r, hw)
            return x + r
        B = x.shape[0]
        recompute = (self.training and self.cfg.with_cp
                     and torch.is_grad_enabled())
        for blk in stage.blocks:
            keep = None
            if self.training and blk.drop_path_rate > 0:
                keep = keep_mask((2, B), blk.drop_path_rate, x.device,
                                 batch_axis=1)
            if recompute:
                x = checkpoint(blk, x, hw, keep)
            else:
                x = blk(x, hw, keep)
        return x

    def stereo_feat(self, x) -> torch.Tensor:
        """The patch embedding and stage 0's blocks alone: (B, H, W, 3) ->
        (B, h, w, C0), the feature ``return_stereo_feat`` puts first (the
        stereo reference frame's pass, BEVDet's ``extract_stereo_ref_feat``)."""
        B = x.shape[0]
        x, hw = self._embed(x)
        x = self._stage_blocks(self.stages[0], x, hw)
        return x.view(B, *hw, x.shape[-1])

    def forward(self, x) -> List[torch.Tensor]:
        cfg = self.cfg
        B = x.shape[0]
        x, hw = self._embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = self._stage_blocks(stage, x, hw)
            if i == 0 and cfg.return_stereo_feat:
                outs.append(x.view(B, *hw, x.shape[-1]))
            if i in cfg.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).view(
                    B, *hw, x.shape[-1]))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs
