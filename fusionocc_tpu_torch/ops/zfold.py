"""The z-folded voxel layout: F = 8 z-consecutive cells per super row.

Port of the structure half of ``fusionocc_tpu/ops/zfold.py``.  A super row
holds the F cells (x, y, s*F .. s*F + F-1) of one super cell (x, y, s) in
F*C lanes, zi-major (lane = zi*C + c); which cells exist is a (B, S, F)
lane mask, and absent cells carry exact zeros.  Neighbour maps are built on
the F-times-smaller super grid (``ops/sparse_conv.stage_indices_table``),
and a 3x3x3 cell kernel becomes 27 super taps whose z structure moves into
the weight (``expand_weight``).  The conv over this layout is
``ops/zwin_conv.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .sparse_conv import sparse_conv_apply
from .voxelize import SparseVoxels, key_set, padded_width, segment_ranks


class ZFoldVoxels(NamedTuple):
    """Batched z-folded voxel set (sorted by super key, valid rows first)."""
    feats: torch.Tensor      # (B, S, F*C) float; lane zi*C + c
    coords: torch.Tensor     # (B, S, 3) int32 super (x, y, s); 0 if invalid
    keys: torch.Tensor       # (B, S) int32 ascending; sentinel = n_super
    mask: torch.Tensor       # (B, S) bool super validity
    lane_mask: torch.Tensor  # (B, S, F) bool cell validity
    fold: int                # F


def super_shape(shape: Tuple[int, int, int], fold: int):
    assert shape[2] % fold == 0, (shape, fold)
    return (shape[0], shape[1], shape[2] // fold)


def as_sparse(zv: ZFoldVoxels) -> SparseVoxels:
    """The super set as a ``SparseVoxels`` for the table index builds."""
    return SparseVoxels(zv.feats, zv.coords, zv.keys, zv.mask)


def expand_lane_mask(lane_mask: torch.Tensor, C: int, dtype) -> torch.Tensor:
    """(..., F) cell mask -> (..., F*C) lane multiplier (zi-major lanes)."""
    return lane_mask.to(dtype).repeat_interleave(C, dim=-1)


def expand_weight(w: torch.Tensor, f_in: int, f_out: int,
                  stride: int) -> torch.Tensor:
    """Lift a (27, Cin, Cout) cell kernel to (27, f_in*Cin, f_out*Cout).

    Out cell zo with kernel z-tap dz reads the in cell r = stride*zo + dz - 1
    from the out super's in-base: super shift ds = floor(r / f_in) + 1 at
    lane zi = r mod f_in.  The tap order is ``KERNEL_OFFSETS`` with dz
    replaced by ds, so super-grid neighbour maps drive it unchanged.
    """
    cin, cout = w.shape[1], w.shape[2]
    assert stride * (f_out - 1) + 1 <= 2 * f_in, (f_in, f_out, stride)
    w9 = w.reshape(9, 3, cin, cout)
    out = w.new_zeros(9, 3, f_in, cin, f_out, cout)
    for zo in range(f_out):
        for dz in range(3):
            r = stride * zo + dz - 1
            out[:, r // f_in + 1, r % f_in, :, zo, :] += w9[:, dz]
    return out.reshape(27, f_in * cin, f_out * cout)


def zfold_regroup(sp: SparseVoxels, shape: Tuple[int, int, int],
                  capacity: int, fold: int) -> ZFoldVoxels:
    """Regroup sorted cell rows into sorted super rows with lane masks.

    Cell keys are z-fastest, so key // F is the super key and a super's
    cells are consecutive rows: a prefix count numbers each sample's supers,
    and one row scatter over the batch places each cell in its super's lane
    (cells cut or invalid go to dump rows).  A sample keeps its first
    ``capacity`` supers (the JAX package's cut).
    """
    B, V, C = sp.feats.shape
    dev = sp.keys.device
    sshape = super_shape(shape, fold)
    skey = torch.where(sp.mask, sp.keys // fold, sshape[0] * sshape[1]
                       * sshape[2])
    sid, first = segment_ranks(skey, sp.mask)
    n = torch.clamp(first.sum(dim=1), max=capacity)
    S = padded_width(n, capacity)
    ok = sp.mask & (sid < capacity)
    row = torch.arange(B, device=dev)[:, None] * S + sid
    dump = torch.arange(V, device=dev)
    slot = torch.where(ok, row * fold + sp.keys % fold, B * S * fold + dump)
    buf = sp.feats.new_zeros(B * S * fold + V, C)
    buf[slot] = sp.feats
    lane = torch.zeros(B * S * fold + V, dtype=torch.bool, device=dev)
    lane[slot] = ok
    keys = torch.zeros(B * S + V, dtype=torch.int32, device=dev)
    keys[torch.where(first & ok, row, B * S + dump)] = skey
    coords, skeys, smask = key_set(keys[:B * S].view(B, S),
                                   torch.arange(S, device=dev) < n[:, None],
                                   sshape)
    return ZFoldVoxels(buf[:B * S * fold].view(B, S, fold * C), coords,
                       skeys, smask, lane[:B * S * fold].view(B, S, fold),
                       fold)


def strided_lane_mask(lane_mask: torch.Tensor, out_smask: torch.Tensor,
                      nbr: torch.Tensor, f_in: int, f_out: int
                      ) -> torch.Tensor:
    """Exact out-cell validity of a stride-2 super conv: an out cell is
    active iff any in cell of its 3x3x3 stride-2 field is, computed by the
    conv's own gather with a 0/1 structure kernel.  The encoder takes it
    from its stage's index build (``ops/sparse_conv.stage_indices_table``
    with the lane mask), whose CUDA path ORs lane bits in the same pass as
    the maps; this is that build's plain version."""
    ones = torch.ones(27, 1, 1, device=lane_mask.device)
    w_occ = expand_weight(ones, f_in, f_out, 2)
    occ = sparse_conv_apply(lane_mask.float(), out_smask, nbr, w_occ)
    return occ > 0.5

