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

The builds are three custom ops in the ``fusionocc`` namespace, split at
that wait: ``stride2_count`` (the candidates' occupancy and prefix count),
``stride2_set`` (the output set at the width read in between) and
``stage_maps`` (a group's row table, both maps and the strided lane mask).
The CPU implementation of each is the plain version (``*_plain``, batched
aten ops: about 90 small launches a stage on the card); the CUDA one
launches ``csrc/sparse_index.cu`` (``*_cuda``: six launches a stage at one
table group, plus the fills of the occupancy grid and the table), with the
same integers.  The path follows the tensors' device, as K1-K3's do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .kernels import KERNELS, stream_ptr
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
# occupancy cells per tile of the index kernels (csrc/sparse_index.cu kTile)
INDEX_TILE = 4096


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


def stride2_count_plain(in_coords: torch.Tensor, in_mask: torch.Tensor,
                        sx: int, sy: int, sz: int, capacity: int):
    """The stride-2 output candidates of a batch: (count, n), count (B,
    n_out) int32 the inclusive count of set output cells per sample, n (B,)
    int32 each sample's outputs, at most ``capacity``.

    Input coordinate d reaches outputs d/2 (d even) or (d±1)/2 (d odd); the
    8 per-axis combinations, one scatter, mark a (B, n_out) occupancy grid
    (plus a dump column for invalid rows and out-of-grid candidates), and
    its prefix count per sample numbers the set cells.
    """
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
    return count, torch.clamp(count[:, -1], max=capacity)


def stride2_set_plain(count: torch.Tensor, n: torch.Tensor, sx: int,
                      sy: int, sz: int, width: int):
    """(coords, keys, mask) of each sample's first n stride-2 outputs,
    ascending, in ``width`` rows: output i is the first cell whose count
    reaches i + 1, found by binary search (JAX's
    ``_downsample_out_set_table_one``)."""
    B = count.shape[0]
    rank = torch.arange(1, width + 1, dtype=torch.int32, device=count.device)
    rank = rank.expand(B, width).contiguous()
    mask = rank <= n[:, None]
    keys = torch.where(mask, torch.searchsorted(count, rank), sx * sy * sz)
    return key_set(keys, mask, (sx, sy, sz))


def stage_maps_plain(keys: torch.Tensor, coords: torch.Tensor,
                     mask: torch.Tensor, out_coords: torch.Tensor,
                     out_mask: torch.Tensor,
                     lane_mask: Optional[torch.Tensor], sx: int, sy: int,
                     sz: int, f_out: int):
    """(subm, strided, lane) of G samples from one row table: the SubM map
    (G, V, 27) of the input rows, the stride-2 map (G, S, 27) of the output
    rows, and the outputs' cell lane mask (G, S, f_out), ``ops/zfold.py``'s
    ``strided_lane_mask`` of the input ``lane_mask`` (G, V, f_in); (G, S, 0)
    without one."""
    from .zfold import strided_lane_mask    # zfold imports this module
    shape = (sx, sy, sz)
    v_in = keys.shape[1]
    table = _row_table(keys, mask, sx * sy * sz)
    subm = _index_from_table(table, coords, mask, shape, 1, v_in)
    strided = _index_from_table(table, out_coords, out_mask, shape, 2, v_in)
    if lane_mask is None:
        lane = out_mask.new_zeros(*out_mask.shape, 0)
    else:
        lane = strided_lane_mask(lane_mask, out_mask, strided,
                                 lane_mask.shape[-1], f_out)
    return subm, strided, lane


def _cuda_operands(*tensors: torch.Tensor) -> torch.device:
    """The device of CUDA operands; raise on any other."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type != 'cuda':
        raise ValueError(f'the index kernels need CUDA tensors on one '
                         f'device, got {[str(t.device) for t in tensors]}')
    return dev


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """``t`` contiguous; raise unless it has ``dtype``."""
    if t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {t.dtype}')
    return t.contiguous()


def stride2_count_cuda(in_coords: torch.Tensor, in_mask: torch.Tensor,
                       sx: int, sy: int, sz: int, capacity: int):
    """``stride2_count_plain`` by three launches (``index_mark``,
    ``index_count``, ``index_prefix``) after one zero fill of the
    occupancy grid, whose rows are padded to whole tiles and followed by
    the B counters that find each sample's last tile."""
    dev = _cuda_operands(in_coords, in_mask)
    coords = _operand(in_coords, torch.int32, 'in_coords')
    mask = _operand(in_mask, torch.bool, 'in_mask')
    B, V = mask.shape
    if coords.shape != (B, V, 3):
        raise ValueError(f'in_coords {tuple(coords.shape)} for mask '
                         f'{tuple(mask.shape)}')
    n_out = sx * sy * sz
    T = -(-n_out // INDEX_TILE)
    n_pad = T * INDEX_TILE
    if n_out >= 2 ** 31:
        raise ValueError(f'{n_out} output cells exceed int32')
    occ = torch.zeros(B * n_pad + 4 * B, dtype=torch.uint8, device=dev)
    tile_off = torch.empty(B, T, dtype=torch.int32, device=dev)
    count = torch.empty(B, n_out, dtype=torch.int32, device=dev)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    done = occ.data_ptr() + B * n_pad
    with torch.cuda.device(dev):
        stream = stream_ptr(dev)
        KERNELS.launch('index_mark', coords.data_ptr(), mask.data_ptr(),
                       occ.data_ptr(), B, V, sx, sy, sz, n_pad, stream)
        KERNELS.launch('index_count', occ.data_ptr(), tile_off.data_ptr(),
                       n.data_ptr(), done, B, T, n_pad, capacity, stream)
        KERNELS.launch('index_prefix', occ.data_ptr(), tile_off.data_ptr(),
                       count.data_ptr(), B, T, n_out, n_pad, stream)
    return count, n


def stride2_set_cuda(count: torch.Tensor, n: torch.Tensor, sx: int, sy: int,
                     sz: int, width: int):
    """``stride2_set_plain`` by one launch (``index_set``): each set cell of
    rank r < n writes row r, each row past n its padding."""
    dev = _cuda_operands(count, n)
    count = _operand(count, torch.int32, 'count')
    n = _operand(n, torch.int32, 'n')
    B, n_out = count.shape
    if n_out != sx * sy * sz or n.shape != (B,):
        raise ValueError(f'count {tuple(count.shape)} and n '
                         f'{tuple(n.shape)} for the shape {(sx, sy, sz)}')
    keys = torch.empty(B, width, dtype=torch.int32, device=dev)
    coords = torch.empty(B, width, 3, dtype=torch.int32, device=dev)
    mask = torch.empty(B, width, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        KERNELS.launch('index_set', count.data_ptr(), n.data_ptr(),
                       keys.data_ptr(), coords.data_ptr(), mask.data_ptr(),
                       B, n_out, width, sy, sz, stream_ptr(dev))
    return coords, keys, mask


def stage_maps_cuda(keys: torch.Tensor, coords: torch.Tensor,
                    mask: torch.Tensor, out_coords: torch.Tensor,
                    out_mask: torch.Tensor,
                    lane_mask: Optional[torch.Tensor], sx: int, sy: int,
                    sz: int, f_out: int):
    """``stage_maps_plain`` by one fill of the row table and two launches:
    ``index_table`` (the rows into the table) and ``index_maps`` (both
    maps and the lane mask, in one pass over the table)."""
    lanes = () if lane_mask is None else (lane_mask,)
    dev = _cuda_operands(keys, coords, mask, out_coords, out_mask, *lanes)
    keys = _operand(keys, torch.int32, 'keys')
    coords = _operand(coords, torch.int32, 'coords')
    out_coords = _operand(out_coords, torch.int32, 'out_coords')
    mask = _operand(mask, torch.bool, 'mask')
    out_mask = _operand(out_mask, torch.bool, 'out_mask')
    G, V = keys.shape
    S = out_mask.shape[1]
    if (coords.shape != (G, V, 3) or mask.shape != (G, V)
            or out_coords.shape != (G, S, 3) or out_mask.shape != (G, S)):
        raise ValueError(f'rows: keys {tuple(keys.shape)}, coords '
                         f'{tuple(coords.shape)}, mask {tuple(mask.shape)}, '
                         f'out_coords {tuple(out_coords.shape)}, out_mask '
                         f'{tuple(out_mask.shape)}')
    f_in = 0
    if lane_mask is None:
        f_out = 0
    else:
        lane_mask = _operand(lane_mask, torch.bool, 'lane_mask')
        f_in = lane_mask.shape[-1]
        # a row's lane bits are one 32-bit word in the kernel
        if (lane_mask.shape[:2] != (G, V) or f_in > 32
                or 2 * (f_out - 1) + 1 > 2 * f_in):
            raise ValueError(f'lane_mask {tuple(lane_mask.shape)} for '
                             f'{G} x {V} rows and f_out {f_out}')
    row_len = sx * sy * sz + 4
    table = torch.full((G, row_len), V, dtype=torch.int32, device=dev)
    subm = torch.empty(G, V, 27, dtype=torch.int32, device=dev)
    strided = torch.empty(G, S, 27, dtype=torch.int32, device=dev)
    lane = torch.empty(G, S, f_out, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = stream_ptr(dev)
        KERNELS.launch('index_table', keys.data_ptr(), mask.data_ptr(),
                       table.data_ptr(), G, V, row_len, stream)
        KERNELS.launch('index_maps', table.data_ptr(), coords.data_ptr(),
                       mask.data_ptr(), out_coords.data_ptr(),
                       out_mask.data_ptr(),
                       lane_mask.data_ptr() if f_out else None,
                       subm.data_ptr(), strided.data_ptr(), lane.data_ptr(),
                       G, V, S, sx, sy, sz, row_len, f_in, f_out, stream)
    return subm, strided, lane


@torch.library.custom_op('fusionocc::stride2_count', mutates_args=(),
                         device_types='cpu')
def stride2_count_op(in_coords: torch.Tensor, in_mask: torch.Tensor, sx: int,
                     sy: int, sz: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stride-2 candidates as a custom op: on the CPU the plain
    version."""
    return stride2_count_plain(in_coords, in_mask, sx, sy, sz, capacity)


@stride2_count_op.register_kernel('cuda')
def _stride2_count_op_cuda(in_coords, in_mask, sx, sy, sz, capacity):
    # the wrappers by their module names, so a caller may wrap them
    return stride2_count_cuda(in_coords, in_mask, sx, sy, sz, capacity)


@stride2_count_op.register_fake
def _stride2_count_op_fake(in_coords, in_mask, sx, sy, sz, capacity):
    B = in_coords.shape[0]
    return (in_coords.new_empty(B, sx * sy * sz, dtype=torch.int32),
            in_coords.new_empty(B, dtype=torch.int32))


@torch.library.custom_op('fusionocc::stride2_set', mutates_args=(),
                         device_types='cpu')
def stride2_set_op(count: torch.Tensor, n: torch.Tensor, sx: int, sy: int,
                   sz: int, width: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stride-2 output set as a custom op: on the CPU the plain
    version."""
    return stride2_set_plain(count, n, sx, sy, sz, width)


@stride2_set_op.register_kernel('cuda')
def _stride2_set_op_cuda(count, n, sx, sy, sz, width):
    return stride2_set_cuda(count, n, sx, sy, sz, width)


@stride2_set_op.register_fake
def _stride2_set_op_fake(count, n, sx, sy, sz, width):
    B = count.shape[0]
    return (count.new_empty(B, width, 3), count.new_empty(B, width),
            count.new_empty(B, width, dtype=torch.bool))


@torch.library.custom_op('fusionocc::stage_maps', mutates_args=(),
                         device_types='cpu')
def stage_maps_op(keys: torch.Tensor, coords: torch.Tensor,
                  mask: torch.Tensor, out_coords: torch.Tensor,
                  out_mask: torch.Tensor, lane_mask: Optional[torch.Tensor],
                  sx: int, sy: int, sz: int, f_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A stage's maps and lane mask as a custom op: on the CPU the plain
    version."""
    return stage_maps_plain(keys, coords, mask, out_coords, out_mask,
                            lane_mask, sx, sy, sz, f_out)


@stage_maps_op.register_kernel('cuda')
def _stage_maps_op_cuda(keys, coords, mask, out_coords, out_mask, lane_mask,
                        sx, sy, sz, f_out):
    return stage_maps_cuda(keys, coords, mask, out_coords, out_mask,
                           lane_mask, sx, sy, sz, f_out)


@stage_maps_op.register_fake
def _stage_maps_op_fake(keys, coords, mask, out_coords, out_mask, lane_mask,
                        sx, sy, sz, f_out):
    G, V = keys.shape
    S = out_mask.shape[1]
    return (keys.new_empty(G, V, 27), keys.new_empty(G, S, 27),
            keys.new_empty(G, S, 0 if lane_mask is None else f_out,
                           dtype=torch.bool))


def _downsample_keys(in_coords: torch.Tensor, in_mask: torch.Tensor,
                     shape_out: Tuple[int, int, int], capacity: int):
    """(coords, keys, mask) of each sample's first ``capacity`` active
    stride-2 outputs, ascending, padded to the largest sample: the
    candidates' counts, the padded width read from the card (the stage's
    one wait), then the set."""
    count, n = stride2_count_op(in_coords, in_mask, *shape_out, capacity)
    return stride2_set_op(count, n, *shape_out, padded_width(n, capacity))


def _joined(parts):
    """The parts of a batch built a group at a time, joined (no copy for
    one group)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def stage_indices_table(sp: SparseVoxels, shape: Tuple[int, int, int],
                        down_capacity: int,
                        lane_mask: Optional[torch.Tensor] = None,
                        f_out: int = 0):
    """All neighbour maps of one encoder stage from one row table per
    sample.

    Returns (subm_nbr, ((out_coords, out_keys, out_mask, strided_nbr),
    shape_out)): subm_nbr (B, V, 27), and the stride-2 output set (at most
    ``down_capacity`` rows per sample) padded to its largest sample.  Given
    the input's cell lane mask ``lane_mask`` (B, V, f_in), the stride-2 set
    also carries its own, (B, S, f_out), read in the same pass as the maps
    (``ops/zfold.strided_lane_mask``'s result): (out_coords, out_keys,
    out_mask, strided_nbr, out_lane).
    """
    n_cells = shape[0] * shape[1] * shape[2]
    B = sp.keys.shape[0]
    shape_out = out_shape_strided(shape)
    out_coords, out_keys, out_mask = _downsample_keys(
        sp.coords, sp.mask, shape_out, down_capacity)
    group = max(1, TABLE_CELLS // (n_cells + 4))
    subm, snbr, lanes = [], [], []
    for b in range(0, B, group):
        s = slice(b, b + group)
        maps = stage_maps_op(sp.keys[s], sp.coords[s], sp.mask[s],
                             out_coords[s], out_mask[s],
                             None if lane_mask is None else lane_mask[s],
                             *shape, f_out)
        for parts, part in zip((subm, snbr, lanes), maps):
            parts.append(part)
    strided = (out_coords, out_keys, out_mask, _joined(snbr))
    if lane_mask is not None:
        strided += (_joined(lanes),)
    return _joined(subm), (strided, shape_out)


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
