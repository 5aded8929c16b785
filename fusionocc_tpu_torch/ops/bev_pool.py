"""Frustum-to-voxel pooling (bev_pool_v2).

Port of ``fusionocc_tpu/ops/bev_pool.py``:

    out[b, z, y, x, c] = sum over frustum points p falling in that voxel of
                         depth[p] * feat[pixel(p), c]

summed in fp32 and cast to the caller's ``out_dtype``.

``prepare_pooling_index`` quantises the frustum points, gives out-of-grid
points a sentinel rank one past the last voxel, sorts stably by rank, finds
each voxel's run of sorted points (``bounds``), the permutation that sorts
the points by feature row (``order_by_feat``, for the backward) and builds
the kernel's work table (``long_runs``): the voxels whose run is longer
than ``max_short`` points, longest first.  ``bev_pool`` then sums the runs
through the custom op ``fusionocc::bev_pool`` (``bev_pool_op``, inside the
autograd ``Function`` ``BevPool``): its CPU
implementation is the plain version, ``index_add_`` over the sorted
points, its CUDA one the kernel (``csrc/bev_pool.cu``), a group of C/8
lanes per short run and a warp per long one.  The JAX package's
cumulative-sum formulation and trimmed index are TPU devices the kernel
does not need.

The backward is JAX's ``_bev_pool_bwd``, the same code on both devices: the
cotangent in fp32, gathered per sorted point; the depth gradient put back in
natural order through the inverse of the ``ranks_depth`` permutation; the
feature gradient a reshape-sum over the D bins of each row in
``order_by_feat`` order (every row owns exactly D points of the untrimmed
index).  With a bf16 ``out_dtype`` the backward sees the cast's cotangent.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GridConfig
from ..utils import profiling
from .kernels import KERNELS, exporting, stream_ptr


# The longest run a group of C/8 lanes sums (the kernel's short items);
# longer runs are one warp's item each.
MAX_SHORT_RUN = 16


class PoolingIndex(NamedTuple):
    """int32 rank tensors sorted ascending by ``ranks_bev`` (sentinel last),
    and the kernel's work table.

    ranks_* have length P = B*N*D*Hf*Wf; ``bounds`` (num_voxels + 1,) holds
    the first sorted position with ``ranks_bev >= v``, so voxel v's points
    are ``bounds[v]:bounds[v+1]`` and ``bounds[-1]`` counts in-grid points.
    ``long_voxels`` lists the voxels whose run is longer than ``max_short``,
    longest first (``long_runs``).  ``order_by_feat`` sorts the points by
    ``ranks_feat`` (the backward's; an index made by hand may leave it out
    and is then forward-only).
    """
    ranks_depth: torch.Tensor   # into the flattened (B, N, D, Hf, Wf) depth
    ranks_feat: torch.Tensor    # into the flattened (B, N, Hf, Wf) feat rows
    ranks_bev: torch.Tensor     # voxel rank; out of grid = num_voxels
    bounds: torch.Tensor
    long_voxels: torch.Tensor
    max_short: int
    order_by_feat: Optional[torch.Tensor] = None


def long_runs(bounds: torch.Tensor, max_short: int,
              num_points: int = 0) -> torch.Tensor:
    """int32 ids of the voxels whose run is longer than ``max_short``
    points, longest first (ties by voxel id): the kernel's warp items.
    Every other voxel, empty ones included, is a short item.  While
    ``torch.export`` traces, the table has a static length, the most long
    runs ``num_points`` points can make (every voxel when it is 0), padded
    with -1, which the kernel skips: ``nonzero``'s length would be read
    from the card."""
    n = bounds[1:] - bounds[:-1]
    if exporting():
        size = n.numel()
        if num_points:
            size = min(size, num_points // (max_short + 1))
        v = torch.nonzero_static(n > max_short, size=max(size, 1),
                                 fill_value=-1).flatten()
        key = torch.where(v >= 0, n[v.clamp_min(0)], -1)
    else:
        with profiling.wait('long_runs'):
            v = torch.nonzero(n > max_short).flatten()
        key = n[v]
    order = torch.sort(key, descending=True, stable=True).indices
    return v[order].to(torch.int32)


def prepare_pooling_index(coor: torch.Tensor, grid: GridConfig,
                          images: Optional[Tuple[int, int]] = None
                          ) -> PoolingIndex:
    """Quantise (B, N, D, Hf, Wf, 3) ego coordinates, sort by voxel and
    build the work table.  ``images`` (a, b): only the flattened images
    a..b-1 of the B*N, each into its own sample's volume, the ranks
    indexing those images' depth and feature rows (a rank's cameras under
    the hybrid mesh); the pooled volume still has B samples."""
    B, N, D, H, W, _ = coor.shape
    a, b = images if images is not None else (0, B * N)
    n = b - a
    P = n * D * H * W
    gx, gy, gz = grid.grid_size
    num_voxels = B * gz * gy * gx
    if max(P, num_voxels + 1) >= 2 ** 31:
        # the ranks and bounds are int32 (the kernel's offsets are int64)
        raise ValueError(f'{P} points or {num_voxels} voxels exceed int32')
    dev = coor.device
    with profiling.wait('pooling_index.constant'):
        lower = torch.tensor(grid.lower_bound, dtype=torch.float32,
                             device=dev)
    with profiling.wait('pooling_index.constant'):
        interval = torch.tensor(grid.interval, dtype=torch.float32,
                                device=dev)

    coor = coor.reshape((B * N,) + coor.shape[2:])[a:b]
    v = torch.floor((coor.float() - lower) / interval).to(torch.int32)
    v = v.reshape(n, D * H * W, 3)
    inside = ((v[..., 0] >= 0) & (v[..., 0] < gx) &
              (v[..., 1] >= 0) & (v[..., 1] < gy) &
              (v[..., 2] >= 0) & (v[..., 2] < gz))
    batch_idx = torch.div(torch.arange(a, b, dtype=torch.int32, device=dev),
                          N, rounding_mode='floor')[:, None]
    # rank = ((b * Z + z) * Y + y) * X + x  (the reference's rank layout)
    rank = ((batch_idx * gz + v[..., 2]) * gy + v[..., 1]) * gx + v[..., 0]
    rank = torch.where(inside, rank, num_voxels).reshape(P).to(torch.int32)

    ranks_feat = torch.arange(n * H * W, dtype=torch.int32, device=dev)
    ranks_feat = ranks_feat.reshape(n, 1, H, W).expand(n, D, H, W)
    rank_s, order = torch.sort(rank, stable=True)
    rf_s = ranks_feat.reshape(P)[order]
    bounds = torch.searchsorted(
        rank_s, torch.arange(num_voxels + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    order_by_feat = torch.argsort(rf_s, stable=True).to(torch.int32)
    return PoolingIndex(order.to(torch.int32), rf_s, rank_s, bounds,
                        long_runs(bounds, MAX_SHORT_RUN, P), MAX_SHORT_RUN,
                        order_by_feat)


def bev_pool_plain(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                   idx: PoolingIndex, num_voxels: int) -> torch.Tensor:
    """(num_voxels, C) float32 sums by ``index_add_`` over sorted points."""
    C = feat_flat.shape[1]
    prod = (depth_flat.float()[idx.ranks_depth.long(), None]
            * feat_flat.float()[idx.ranks_feat.long()])
    out = torch.zeros(num_voxels + 1, C, dtype=torch.float32,
                      device=feat_flat.device)
    out.index_add_(0, idx.ranks_bev.long(), prod)
    return out[:num_voxels]


def bev_pool_cuda(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                  idx: PoolingIndex, num_voxels: int,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch ``bev_pool_fwd``: feat read in its dtype (fp32 or bf16), the
    fp32 sums written as ``out_dtype`` (fp32 or bf16)."""
    dev = feat_flat.device
    if dev.type != 'cuda':
        raise ValueError(f'bev_pool_cuda needs CUDA tensors, got {dev}')
    C = feat_flat.shape[1]
    if C not in (8, 32):
        raise ValueError(f'bev_pool_cuda takes 8 or 32 channels, got {C}')
    kinds = {torch.float32: 0, torch.bfloat16: 1}
    if feat_flat.dtype not in kinds or out_dtype not in kinds:
        raise ValueError(f'bev_pool_cuda takes fp32 or bf16 feat and out, '
                         f'got {feat_flat.dtype} and {out_dtype}')
    if depth_flat.dtype != torch.float32:
        raise ValueError(f'depth must be float32, got {depth_flat.dtype}')
    depth_flat = depth_flat.contiguous()
    feat_flat = feat_flat.contiguous()
    if feat_flat.data_ptr() % 16:
        raise ValueError('feat must be 16-byte aligned')
    for name in ('ranks_depth', 'ranks_feat', 'bounds', 'long_voxels'):
        t = getattr(idx, name)
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous int32 on {dev}')
    if idx.bounds.shape != (num_voxels + 1,):
        raise ValueError(f'bounds has shape {tuple(idx.bounds.shape)}, '
                         f'expected ({num_voxels + 1},)')
    if depth_flat.device != dev:
        raise ValueError('depth and feat must be on one device')
    out = torch.empty(num_voxels, C, dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        KERNELS.launch(
            'bev_pool_fwd', depth_flat.data_ptr(), feat_flat.data_ptr(),
            idx.ranks_depth.data_ptr(), idx.ranks_feat.data_ptr(),
            idx.bounds.data_ptr(), idx.long_voxels.data_ptr(),
            idx.long_voxels.numel(), out.data_ptr(), num_voxels, C,
            idx.max_short, kinds[feat_flat.dtype], kinds[out_dtype],
            stream_ptr(dev))
    return out


def bev_pool_bwd(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                 idx: PoolingIndex, g: torch.Tensor):
    """JAX's ``_bev_pool_bwd``: (d_depth, d_feat) in depth's and feat's
    dtypes for the cotangent g (num_voxels, C) of the pooled sums."""
    if idx.order_by_feat is None:
        raise ValueError('the backward needs the index\'s order_by_feat '
                         '(prepare_pooling_index builds it)')
    g = g.float()
    g_pts = torch.cat([g, g.new_zeros(1, g.shape[1])])[idx.ranks_bev.long()]
    rd = idx.ranks_depth.long()
    feat_pts = feat_flat[idx.ranks_feat.long()].float()
    depth_pts = depth_flat[rd].float()
    # ranks_depth is a permutation: scattering by it applies its inverse
    d_sorted = (g_pts * feat_pts).sum(dim=-1)
    d_depth = torch.empty_like(d_sorted).index_put_((rd,), d_sorted)
    rows = feat_flat.shape[0]
    contrib = (depth_pts[:, None] * g_pts)[idx.order_by_feat.long()]
    per_row = rd.numel() // rows if rows else 0     # D; no rows: no images
    d_feat = contrib.reshape(rows, per_row, g.shape[1]).sum(dim=1)
    return d_depth.to(depth_flat.dtype), d_feat.to(feat_flat.dtype)


def _index(ranks_depth, ranks_feat, ranks_bev, bounds, long_voxels,
           max_short):
    return PoolingIndex(ranks_depth, ranks_feat, ranks_bev, bounds,
                        long_voxels, max_short)


@torch.library.custom_op('fusionocc::bev_pool', mutates_args=(),
                         device_types='cpu')
def bev_pool_op(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                ranks_depth: torch.Tensor, ranks_feat: torch.Tensor,
                ranks_bev: torch.Tensor, bounds: torch.Tensor,
                long_voxels: torch.Tensor, num_voxels: int, max_short: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """K1 as a custom op on a ``PoolingIndex``'s tensors: on the CPU the
    plain version, cast once to ``out_dtype``."""
    idx = _index(ranks_depth, ranks_feat, ranks_bev, bounds, long_voxels,
                 max_short)
    return bev_pool_plain(depth_flat, feat_flat, idx, num_voxels
                          ).to(out_dtype)


@bev_pool_op.register_kernel('cuda')
def _bev_pool_op_cuda(depth_flat, feat_flat, ranks_depth, ranks_feat,
                      ranks_bev, bounds, long_voxels, num_voxels, max_short,
                      out_dtype):
    idx = _index(ranks_depth, ranks_feat, ranks_bev, bounds, long_voxels,
                 max_short)
    return bev_pool_cuda(depth_flat, feat_flat, idx, num_voxels, out_dtype)


@bev_pool_op.register_fake
def _bev_pool_op_fake(depth_flat, feat_flat, ranks_depth, ranks_feat,
                      ranks_bev, bounds, long_voxels, num_voxels, max_short,
                      out_dtype):
    return feat_flat.new_empty(num_voxels, feat_flat.shape[1],
                               dtype=out_dtype)


class BevPool(torch.autograd.Function):
    """Forward: ``bev_pool_op`` (the plain version for CPU tensors, K1
    otherwise); backward: ``bev_pool_bwd`` on both."""

    @staticmethod
    def forward(ctx, depth_flat, feat_flat, idx, num_voxels, out_dtype):
        ctx.save_for_backward(depth_flat, feat_flat)
        ctx.idx = idx
        return bev_pool_op(depth_flat, feat_flat, idx.ranks_depth,
                           idx.ranks_feat, idx.ranks_bev, idx.bounds,
                           idx.long_voxels, num_voxels, idx.max_short,
                           out_dtype)

    @staticmethod
    def backward(ctx, g):
        return (*bev_pool_bwd(*ctx.saved_tensors, ctx.idx, g), None, None,
                None)


def bev_pool_flat(depth_flat: torch.Tensor, feat_flat: torch.Tensor,
                  idx: PoolingIndex, num_voxels: int,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(num_voxels, C) pooled sums of flat depth (P,) and feat (rows, C),
    cast once to ``out_dtype``; differentiable in depth and feat."""
    return BevPool.apply(depth_flat, feat_flat, idx, num_voxels, out_dtype)


def bev_pool(depth: torch.Tensor, feat: torch.Tensor, idx: PoolingIndex,
             grid: GridConfig, out_dtype: torch.dtype = torch.float32
             ) -> torch.Tensor:
    """Pool per-pixel depth-weighted features into the voxel grid.

    depth: (B, N, D, Hf, Wf) softmaxed depth, float32; feat: (B, N, Hf, Wf,
    C) in its own dtype.  Returns (B', Z, Y, X, C) in ``out_dtype``: the
    fp32 sums cast once, B' the index's samples (B unless the index pools
    a block of images: ``prepare_pooling_index(images=)``).  Plain version
    for CPU tensors, the CUDA kernel otherwise.
    """
    C = feat.shape[-1]
    gx, gy, gz = grid.grid_size
    num_voxels = idx.bounds.shape[0] - 1
    B = num_voxels // (gz * gy * gx)
    out = bev_pool_flat(depth.reshape(-1), feat.reshape(-1, C), idx,
                        num_voxels, out_dtype)
    return out.reshape(B, gz, gy, gx, C)
