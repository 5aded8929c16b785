"""Neighbour maps and small sparse-conv helpers for the z-folded encoder.

Port of the table index builds of ``fusionocc_tpu/ops/sparse_conv.py``
(``stage_indices_table`` and its helpers) with ``sparse_conv_apply``,
``sparse_conv1x1_apply`` and ``sparse_to_dense``.

A neighbour map is (B, V_out, 27) int32 in ``KERNEL_OFFSETS`` order: tap
t = dx*9 + dy*3 + dz reads the input at out*stride + (dx, dy, dz) - 1, and a
miss points at row V_in (one past the input rows), as in JAX.  One dense
cell -> row table per stage serves the stage's SubM map and its stride-2
map (spconv's ``indice_key`` sharing).  At full size the stage-0 super grid
is 1600x1600x16, so its table is 164 MB of int32 per sample.

The stride-2 output set is the JAX package's: an output site is active iff
any active input lies in its 3x3x3 stride-2 receptive field, and a sample
keeps its first ``capacity`` output keys ascending.  The builds run on the
whole batch at once on the inputs' device, as JAX's ``vmap`` does: one
occupancy grid and one prefix count over the batch find every sample's
output set, and each row table holds several samples side by side (a
sample offset per row of the table).  Above ``TABLE_CELLS`` cells the
tables are built a few samples at a time, as JAX's ``lax.map`` does above
``_TABLE_VMAP_CELLS``: a loop of launches, never a wait.  Invalid rows write
dump slots instead of being filtered out, so a stage's builds wait for the
card once, for the width of the stride-2 output set; ``sparse_to_dense``
never waits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .voxelize import SparseVoxels, key_set, padded_width

KERNEL_OFFSETS = np.stack(np.meshgrid(
    np.arange(3), np.arange(3), np.arange(3), indexing='ij'),
    axis=-1).reshape(27, 3)   # (27, 3) of (dx, dy, dz) in {0,1,2}


def out_shape_strided(shape: Tuple[int, int, int], stride: int = 2,
                      kernel: int = 3, padding: int = 1
                      ) -> Tuple[int, int, int]:
    return tuple((s + 2 * padding - kernel) // stride + 1 for s in shape)


# cells of the row tables built at once; JAX's _TABLE_VMAP_CELLS
TABLE_CELLS = 2 ** 26


def _row_table(keys: torch.Tensor, mask: torch.Tensor,
               n_cells: int) -> torch.Tensor:
    """(G, n_cells + 4) int32 cell -> row tables of G samples, miss -> V.

    Column c holds cell c - 1: one miss column in front and two behind, so
    the 3-tap z slice starting at column c reads cells (c-1, c, c+1) without
    clamping.  Invalid rows write the last column, which no lookup reads.
    """
    G, v = keys.shape
    table = torch.full((G, n_cells + 4), v, dtype=torch.int32,
                       device=keys.device)
    col = torch.where(mask, keys.long() + 1, n_cells + 3)
    rows = torch.arange(v, dtype=torch.int32, device=keys.device)
    return table.scatter_(1, col, rows.expand(G, v))


def _index_from_table(table: torch.Tensor, out_coords: torch.Tensor,
                      out_mask: torch.Tensor,
                      shape_in: Tuple[int, int, int], stride: int,
                      v_in: int) -> torch.Tensor:
    """(G, V_out, 27) neighbour maps read from G row tables; miss -> v_in."""
    sx, sy, sz = shape_in
    G = table.shape[0]
    g = torch.arange(9, dtype=torch.int32, device=table.device)[:, None]
    qx = out_coords[:, None, :, 0] * stride + g // 3 - 1   # (G, 9, V)
    qy = out_coords[:, None, :, 1] * stride + g % 3 - 1    # g = dx*3+dy
    zb = (out_coords[..., 2] * stride)[:, None, :]          # (G, 1, V)
    ok_xy = (out_mask[:, None, :] & (qx >= 0) & (qx < sx)
             & (qy >= 0) & (qy < sy))
    # column c holds cell c-1, so taps dz = 0, 1, 2 sit at c + dz
    c = torch.where(ok_xy, (qx * sy + qy) * sz + zb, sx * sy * sz).long()
    c += torch.arange(G, device=table.device)[:, None, None] * table.shape[1]
    dz = torch.arange(3, device=table.device)[:, None, None, None]
    zt = zb + dz - 1                                         # (3, G, 1, V)
    ok = ok_xy & (zt >= 0) & (zt < sz)
    nbr = torch.where(ok, table.view(-1)[c + dz], v_in)      # (3, G, 9, V)
    nbr = nbr.permute(1, 2, 0, 3)                  # (G, 9, 3, V) tap-major
    return nbr.reshape(G, 27, -1).transpose(1, 2).contiguous()


def _downsample_keys(in_coords: torch.Tensor, in_mask: torch.Tensor,
                     shape_out: Tuple[int, int, int], capacity: int):
    """(coords, keys, mask) of each sample's first ``capacity`` active
    stride-2 outputs, ascending, padded to the largest sample.

    Input coordinate d reaches outputs d/2 (d even) or (d±1)/2 (d odd); the
    8 per-axis combinations, one scatter, mark a (B, n_out) occupancy grid
    (plus a dump column for invalid rows and out-of-grid candidates).  Its
    prefix count per sample numbers the set cells, and output i of a sample
    is the first cell whose count reaches i + 1, found by binary search
    (JAX's ``_downsample_out_set_table_one``).
    """
    sx, sy, sz = shape_out
    n_out = sx * sy * sz
    B = in_coords.shape[0]
    d = in_coords.long()
    even = (d % 2) == 0
    cands = torch.stack([torch.where(even, d // 2, (d + 1) // 2),
                         torch.where(even, d // 2, (d - 1) // 2)])
    x = cands[:, None, None, ..., 0]                    # (2, 1, 1, B, V)
    y = cands[None, :, None, ..., 1]                    # (1, 2, 1, B, V)
    z = cands[None, None, :, ..., 2]                    # (1, 1, 2, B, V)
    ok = (in_mask & (x >= 0) & (x < sx) & (y >= 0) & (y < sy)
          & (z >= 0) & (z < sz))                        # (2, 2, 2, B, V)
    key = torch.where(ok, (x * sy + y) * sz + z, n_out)
    occ = torch.zeros(B, n_out + 1, dtype=torch.bool, device=d.device)
    occ.scatter_(1, key.permute(3, 0, 1, 2, 4).reshape(B, -1), True)
    count = occ[:, :n_out].cumsum(dim=1, dtype=torch.int32)
    n = torch.clamp(count[:, -1], max=capacity)
    S = padded_width(n, capacity)
    rank = torch.arange(1, S + 1, dtype=torch.int32, device=d.device)
    rank = rank.expand(B, S).contiguous()
    mask = rank <= n[:, None]
    keys = torch.where(mask, torch.searchsorted(count, rank), n_out)
    return key_set(keys, mask, shape_out)


def stage_indices_table(sp: SparseVoxels, shape: Tuple[int, int, int],
                        down_capacity: int):
    """All neighbour maps of one encoder stage from one row table per
    sample.

    Returns (subm_nbr, ((out_coords, out_keys, out_mask, strided_nbr),
    shape_out)): subm_nbr (B, V, 27), and the stride-2 output set (at most
    ``down_capacity`` rows per sample) padded to its largest sample.
    """
    n_cells = shape[0] * shape[1] * shape[2]
    B, v_in = sp.keys.shape
    shape_out = out_shape_strided(shape)
    out_coords, out_keys, out_mask = _downsample_keys(
        sp.coords, sp.mask, shape_out, down_capacity)
    group = max(1, TABLE_CELLS // (n_cells + 4))
    subm, snbr = [], []
    for b in range(0, B, group):
        s = slice(b, b + group)
        table = _row_table(sp.keys[s], sp.mask[s], n_cells)
        subm.append(_index_from_table(table, sp.coords[s], sp.mask[s],
                                      shape, 1, v_in))
        snbr.append(_index_from_table(table, out_coords[s], out_mask[s],
                                      shape, 2, v_in))
    return torch.cat(subm), ((out_coords, out_keys, out_mask,
                              torch.cat(snbr)), shape_out)


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, V, C), idx (B, ...) int rows in [0, V]; row V reads zeros.
    Returns (B, ..., C).  One ``index_select`` over the batch's rows, whose
    backward is an ``index_add_`` (a row read by many taps sums their
    gradients there)."""
    B, V, C = feats.shape
    pad = torch.cat([feats, feats.new_zeros(B, 1, C)], dim=1)
    base = torch.arange(B, device=feats.device) * (V + 1)
    rows = idx.long() + base.view((B,) + (1,) * (idx.dim() - 1))
    return pad.reshape(B * (V + 1), C).index_select(0, rows.reshape(-1)
                                                    ).view(*idx.shape, C)


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
    """Scatter (B, V, C) voxel rows into a dense (B, X, Y, Z, C) volume:
    one row scatter over the batch, invalid rows to dump rows past it."""
    B, V, C = feats.shape
    sx, sy, sz = shape
    n = sx * sy * sz
    dense = feats.new_zeros(B * n + V, C)
    base = torch.arange(B, device=feats.device)[:, None] * n
    dump = B * n + torch.arange(V, device=feats.device)
    dense[torch.where(mask, base + keys.long(), dump)] = feats
    return dense[:B * n].view(B, sx, sy, sz, C)
