"""The BEV trunk on Y blocks: the spatial half of the hybrid mesh.

What XLA's partitioner does to the JAX package's trunk
(``fusionocc_tpu/models/fusion_occ.py:299-301``), written out for the
modules of ``parallel/hybrid.py``'s trunk on this rank's Y rows:

- a conv (k, stride s, padding p) gives the output rows of this rank's
  block of the output axis (ceil(n / ranks) rows each, XLA's blocks); they
  read input rows [oa*s - p, (ob-1)*s - p + k), which ``HybridMesh.exchange``
  assembles from the ranks that hold them (rows beyond the global edge are
  the conv's zero padding).  A 3x3x3 conv at stride 1 takes one row from
  each neighbour; a stride-2 conv takes what its output block reads, which
  with uneven blocks may be a row on one side only; a 1x1x1 conv takes
  none.  Where (ranks - 1) * ceil(n / ranks) >= n the last blocks are
  empty (XLA pads them): such a rank sends nothing and no rank reads a
  row from it, so no padded row passes through a layer; it still enters
  every exchange and collective, in the same order as the others;
- the FPN's trilinear upsample (``align_corners=True``) maps each output
  row to a global source position, i*(n_in-1)/(n_out-1): each rank
  gathers the source rows its output rows read, interpolates Z and X with
  ``F.interpolate`` and Y by those global positions, in float32;
- BatchNorm, ReLU, the residual adds and the predicter act per voxel.

Volumes are NCDHW inside, (B, C, Z, Y, X): Y is axis 3.  A layer's
function returns its output block and, but for the FPN's, the output
axis's global length.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .mesh import HybridMesh

Y = 3       # the Y axis of an NCDHW volume


def conv(m: HybridMesh, x: torch.Tensor, mod: torch.nn.Conv3d, n: int,
         name: str) -> Tuple[torch.Tensor, int]:
    """``mod`` (a Conv3d computing in the input's dtype) on this rank's
    block of an axis of ``n`` rows: (output block, output length).  A rank
    with no output rows reads none and returns an empty block, made by the
    same ops as a full one, so that every rank's backward runs its
    collectives in one order."""
    k, s, p = mod.kernel_size[1], mod.stride[1], mod.padding[1]
    n_out = (n + 2 * p - k) // s + 1
    have, out = m.rows(n), m.rows(n_out)
    reads = [(oa * s - p, (ob - 1) * s - p + k) for oa, ob in out]
    need = [(max(lo, 0), min(hi, n)) if ob > oa else (ha, ha)
            for (lo, hi), (oa, ob), (ha, _) in zip(reads, out, have)]
    if need != have:
        x = m.exchange(x, Y, have, need, name)
    oa, ob = out[m.s]
    if oa == ob:    # no output rows: a conv of k zero rows, then none kept
        x, pad = x.narrow(Y, 0, 0), (k, 0)
    else:
        lo, hi = reads[m.s]
        pad = (max(-lo, 0), max(hi - n, 0))
    x = F.pad(x, (0, 0) + pad)
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    y = F.conv3d(x, mod.weight.to(x.dtype), bias, mod.stride,
                 (mod.padding[0], 0, mod.padding[2]))
    return (y if ob > oa else y.narrow(Y, 0, 0)), n_out


def conv_bn(m: HybridMesh, mod, x: torch.Tensor, n: int, name: str):
    """``nn.layers.ConvBN`` on a Y block."""
    y, n = conv(m, x, mod.conv, n, f'{name}.conv')
    y = mod.bn(y)
    return (F.relu(y) if mod.act else y), n


def basic_block(m: HybridMesh, blk, x: torch.Tensor, n: int, name: str):
    """``nn.layers.BasicBlock3D`` on a Y block."""
    identity = x
    if blk.downsample is not None:
        identity, _ = conv_bn(m, blk.downsample, x, n, f'{name}.downsample')
    y, n_out = conv_bn(m, blk.conv1, x, n, f'{name}.conv1')
    y, _ = conv_bn(m, blk.conv2, y, n_out, f'{name}.conv2')
    return F.relu(y + identity), n_out


def resnet(m: HybridMesh, net, x: torch.Tensor, n: int, name: str
           ) -> List[Tuple[torch.Tensor, int]]:
    """``models.fpn.CustomResNet3D`` on a Y block of (B, Z, Y, X, C):
    every stage's output block (B, Z, Y, X, C) and its Y length."""
    x = x.permute(0, 4, 1, 2, 3)
    feats = []
    for i, stage in enumerate(net.layers):
        for j, blk in enumerate(stage):
            x, n = basic_block(m, blk, x, n, f'{name}.layers.{i}.{j}')
        feats.append((x.permute(0, 2, 3, 4, 1), n))
    return feats


def upsample(m: HybridMesh, x: torch.Tensor, n: int, scale: int,
             name: str) -> torch.Tensor:
    """``ops.grid_sample.resize_trilinear(x, scale)`` on a Y block of an
    axis of ``n`` rows (NCDHW): this rank's block of the n*scale output
    rows, in float32."""
    n_out = n * scale
    step = torch.tensor((n - 1) / (n_out - 1) if n_out > 1 else 0.0,
                        dtype=torch.float32)
    have, taps = m.rows(n), []
    for oa, ob in m.rows(n_out):
        pos = torch.arange(oa, ob, dtype=torch.float32) * step
        h0 = pos.long()
        taps.append((h0, torch.clamp(h0 + 1, max=n - 1), pos - h0))
    need = [(int(h0[0]), int(h1[-1]) + 1) if len(h0) else (ha, ha)
            for (h0, h1, _), (ha, _) in zip(taps, have)]
    if need != have:
        x = m.exchange(x, Y, have, need, name)
    h0, h1, lam = (t.to(x.device) for t in taps[m.s])
    lo = need[m.s][0]
    if not len(h0):     # no output rows: one zero row, none selected
        x, lo = F.pad(x.narrow(Y, 0, 0), (0, 0, 0, 1)), 0
    D, W = x.shape[2], x.shape[4]
    x = F.interpolate(x.float(), size=(D * scale, x.shape[Y], W * scale),
                      mode='trilinear', align_corners=True)
    lam = lam.view(1, 1, 1, -1, 1)
    return (x.index_select(Y, h0 - lo) * (1.0 - lam)
            + x.index_select(Y, h1 - lo) * lam)


def fpn3d(m: HybridMesh, neck, feats: Sequence[Tuple[torch.Tensor, int]],
          name: str) -> torch.Tensor:
    """``models.fpn.LSSFPN3D`` on Y blocks: (B, Z, Y, X, C) out."""
    (x8, n8), (x16, n16), (x32, n32) = feats
    if (n16 * 2, n32 * 4) != (n8, n8):
        raise ValueError(f'the FPN upsamples Y {n16} x2 and {n32} x4 onto '
                         f'{n8}')
    x8 = x8.permute(0, 4, 1, 2, 3)
    ups = [upsample(m, f.permute(0, 4, 1, 2, 3), k, s, f'{name}.up{s}')
           for f, k, s in ((x16, n16, 2), (x32, n32, 4))]
    x = torch.cat([x8] + [u.to(x8.dtype) for u in ups], dim=1)
    y, _ = conv_bn(m, neck.conv, x, n8, f'{name}.conv')
    return y.permute(0, 2, 3, 4, 1)
