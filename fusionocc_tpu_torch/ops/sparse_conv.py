"""Neighbour maps and small sparse-conv helpers for the z-folded encoder.

Port of the table index builds of ``fusionocc_tpu/ops/sparse_conv.py``
(``stage_indices_table`` and its helpers) with ``sparse_conv_apply``,
``sparse_conv1x1_apply`` and ``sparse_to_dense``.

A neighbour map is (B, V_out, 27) int32 in ``KERNEL_OFFSETS`` order: tap
t = dx*9 + dy*3 + dz reads the input at out*stride + (dx, dy, dz) - 1, and a
miss points at row V_in (one past the input rows), as in JAX.  One dense
cell -> row table per stage serves the stage's SubM map and its stride-2
map (spconv's ``indice_key`` sharing).  At full size the stage-0 super grid
is 1600x1600x16, so its table is 164 MB of int32: plain on the card.

The stride-2 output set is the JAX package's: an output site is active iff
any active input lies in its 3x3x3 stride-2 receptive field, and a sample
keeps its first ``capacity`` output keys ascending.  Each sample is built on
its own (a Python loop over the batch); the builds run on the inputs'
device.  Invalid rows write a dump slot past the end instead of being
filtered out, so a stage's builds wait for the device once, for the size
of the stride-2 output set.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .voxelize import SparseVoxels, key_set, key_to_coords, pad_stack

KERNEL_OFFSETS = np.stack(np.meshgrid(
    np.arange(3), np.arange(3), np.arange(3), indexing='ij'),
    axis=-1).reshape(27, 3)   # (27, 3) of (dx, dy, dz) in {0,1,2}


def out_shape_strided(shape: Tuple[int, int, int], stride: int = 2,
                      kernel: int = 3, padding: int = 1
                      ) -> Tuple[int, int, int]:
    return tuple((s + 2 * padding - kernel) // stride + 1 for s in shape)


def _row_table_one(keys: torch.Tensor, mask: torch.Tensor,
                   n_cells: int) -> torch.Tensor:
    """(n_cells + 3,) int32 cell -> row table, miss -> V.

    Padded by one miss cell in front and two behind, so the 3-tap z slice
    starting at table index c reads cells (c-1, c, c+1) without clamping.
    """
    v = keys.shape[0]
    table = torch.full((n_cells + 4,), v, dtype=torch.int32,
                       device=keys.device)
    # invalid rows write the dump slot n_cells + 3, cut off below
    table[torch.where(mask, keys.long() + 1, n_cells + 3)] = torch.arange(
        v, dtype=torch.int32, device=keys.device)
    return table[:n_cells + 3]


def _index_from_table_one(table: torch.Tensor, out_coords: torch.Tensor,
                          out_mask: torch.Tensor,
                          shape_in: Tuple[int, int, int], stride: int,
                          v_in: int) -> torch.Tensor:
    """(V_out, 27) neighbour map read from a row table; miss -> v_in."""
    sx, sy, sz = shape_in
    g = torch.arange(9, dtype=torch.int32, device=table.device)[:, None]
    qx = out_coords[None, :, 0] * stride + g // 3 - 1   # (9, V); g = dx*3+dy
    qy = out_coords[None, :, 1] * stride + g % 3 - 1
    zb = (out_coords[:, 2] * stride)[None, :]                     # (1, V)
    ok_xy = (out_mask[None, :] & (qx >= 0) & (qx < sx)
             & (qy >= 0) & (qy < sy))
    # table index c holds cell c-1, so taps dz = 0, 1, 2 sit at c + dz
    c = torch.where(ok_xy, (qx * sy + qy) * sz + zb, sx * sy * sz).long()
    taps = []
    for dz in range(3):
        zt = zb + dz - 1
        ok = ok_xy & (zt >= 0) & (zt < sz)
        taps.append(torch.where(ok, table[c + dz], v_in))
    nbr = torch.stack(taps, dim=1)                  # (9, 3, V) tap-major
    return nbr.reshape(27, -1).t().contiguous().to(torch.int32)


def _downsample_keys_one(in_coords: torch.Tensor, in_mask: torch.Tensor,
                         shape_out: Tuple[int, int, int],
                         capacity: int) -> torch.Tensor:
    """Sorted keys of the first ``capacity`` active stride-2 outputs.

    Input coordinate d reaches outputs d/2 (d even) or (d±1)/2 (d odd); the
    8 per-axis combinations mark a dense occupancy grid (plus a dump cell
    for invalid rows and out-of-grid candidates) whose set cells, in
    ascending order, are the output set.
    """
    sx, sy, sz = shape_out
    n_out = sx * sy * sz
    d = in_coords.long()
    even = (d % 2) == 0
    cands = (torch.where(even, d // 2, (d + 1) // 2),
             torch.where(even, d // 2, (d - 1) // 2))
    occ = torch.zeros(n_out + 1, dtype=torch.bool, device=d.device)
    for ix in range(2):
        for iy in range(2):
            for iz in range(2):
                x, y, z = cands[ix][:, 0], cands[iy][:, 1], cands[iz][:, 2]
                ok = (in_mask & (x >= 0) & (x < sx) & (y >= 0) & (y < sy)
                      & (z >= 0) & (z < sz))
                occ[torch.where(ok, (x * sy + y) * sz + z, n_out)] = True
    return occ[:n_out].nonzero().squeeze(1)[:capacity].to(torch.int32)


def stage_indices_table(sp: SparseVoxels, shape: Tuple[int, int, int],
                        down_capacity: int):
    """All neighbour maps of one encoder stage from one row table per sample.

    Returns (subm_nbr, ((out_coords, out_keys, out_mask, strided_nbr),
    shape_out)): subm_nbr (B, V, 27), and the stride-2 output set (at most
    ``down_capacity`` rows per sample) padded like the input.
    """
    n_cells = shape[0] * shape[1] * shape[2]
    v_in = sp.keys.shape[1]
    shape_out = out_shape_strided(shape)
    subm, out_keys, snbr = [], [], []
    for b in range(sp.keys.shape[0]):
        table = _row_table_one(sp.keys[b], sp.mask[b], n_cells)
        subm.append(_index_from_table_one(table, sp.coords[b], sp.mask[b],
                                          shape, 1, v_in))
        okeys = _downsample_keys_one(sp.coords[b], sp.mask[b], shape_out,
                                     down_capacity)
        out_keys.append(okeys)
        snbr.append(_index_from_table_one(
            table, key_to_coords(okeys, shape_out),
            torch.ones_like(okeys, dtype=torch.bool), shape, 2, v_in))
    return torch.stack(subm), ((*key_set(out_keys, shape_out),
                                pad_stack(snbr, v_in)), shape_out)


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, V, C), idx (B, ...) int rows in [0, V]; row V reads zeros.
    Returns (B, ..., C)."""
    B, V, C = feats.shape
    pad = torch.cat([feats, feats.new_zeros(B, 1, C)], dim=1)
    bi = torch.arange(B, device=feats.device).view((B,) + (1,) * (idx.dim() - 1))
    return pad[bi, idx.long()]


def sparse_conv_apply(feats: torch.Tensor, mask_out: torch.Tensor,
                      nbr_idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Gather-GEMM out[v] = sum_k feats[nbr[v, k]] @ W[k], fp32 sums.

    feats (B, V_in, Cin), nbr_idx (B, V_out, 27), weight (27, Cin, Cout).
    Returns (B, V_out, Cout) in feats' dtype, zero at invalid outputs.
    """
    B, v_out, _ = nbr_idx.shape
    cin, cout = weight.shape[1], weight.shape[2]
    gat = gather_rows(feats, nbr_idx).reshape(B, v_out, 27 * cin)
    out = gat.float() @ weight.to(feats.dtype).float().reshape(27 * cin, cout)
    return torch.where(mask_out[..., None], out.to(feats.dtype), 0)


def sparse_conv1x1_apply(feats: torch.Tensor, mask: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """1x1x1 submanifold conv: a per-voxel linear map in feats' dtype."""
    out = feats @ weight.to(feats.dtype)
    return torch.where(mask[..., None], out, 0)


def sparse_to_dense(feats: torch.Tensor, keys: torch.Tensor,
                    mask: torch.Tensor,
                    shape: Tuple[int, int, int]) -> torch.Tensor:
    """Scatter (B, V, C) voxel rows into a dense (B, X, Y, Z, C) volume."""
    B, _, C = feats.shape
    sx, sy, sz = shape
    dense = feats.new_zeros(B, sx * sy * sz, C)
    for b in range(B):
        dense[b, keys[b][mask[b]].long()] = feats[b][mask[b]]
    return dense.reshape(B, sx, sy, sz, C)
