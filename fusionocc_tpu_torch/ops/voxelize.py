"""Dynamic voxelization: padded point clouds -> sorted unique voxels.

Port of ``fusionocc_tpu/ops/voxelize.py``.  Conventions shared by the
port's sparse stack (``ops/zfold.py``, ``ops/sparse_conv.py``):

- voxel key = (x * SY + y) * SZ + z, int32, ascending per sample;
- a sample keeps its first ``capacity`` keys ascending, the JAX package's
  static-capacity cut, so both packages hold the same set when a cloud
  overflows;
- sets have their own size: a batch is padded to its largest sample, not to
  the capacity.  Padded rows carry the sentinel key SX*SY*SZ, zero coords
  and features, and mask False;
- every build runs on the whole batch at once on the inputs' device, as
  JAX's ``vmap`` does: no loop over the samples.  The padded width is the
  one number a build reads from the card (``padded_width``), so each build
  waits for the card once, whatever the batch size (and never while
  ``torch.export`` traces: the width is then the capacity).

Points are binned with ``floor`` in fp32 exactly as the JAX package does.
The mean is an exact segment mean: each voxel's few points are summed in
float64 and divided once.  (The JAX package differences fp32 prefix sums
over the whole sorted cloud instead, which is 9.37e-2 m off on the
full-size synthetic cloud; tests/test_torch_lidar_ops.py, ROADMAP Queue C.)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import profiling
from .kernels import exporting


class SparseVoxels(NamedTuple):
    """Batched voxel set, per-sample sorted by key, valid rows first."""
    feats: torch.Tensor   # (B, V, C) float
    coords: torch.Tensor  # (B, V, 3) int32 (x, y, z); 0 where invalid
    keys: torch.Tensor    # (B, V) int32 ascending; sentinel = prod(shape)
    mask: torch.Tensor    # (B, V) bool


def coords_to_key(coords: torch.Tensor, shape: Tuple[int, int, int],
                  valid: torch.Tensor) -> torch.Tensor:
    """int32 lexicographic key; invalid entries get the sentinel."""
    sx, sy, sz = shape
    key = (coords[..., 0] * sy + coords[..., 1]) * sz + coords[..., 2]
    return torch.where(valid, key, sx * sy * sz).to(torch.int32)


def key_to_coords(keys: torch.Tensor,
                  shape: Tuple[int, int, int]) -> torch.Tensor:
    _, sy, sz = shape
    x = keys // (sy * sz)
    rem = keys - x * (sy * sz)
    y = rem // sz
    return torch.stack([x, y, rem - y * sz], dim=-1).to(torch.int32)


def device_vector(values, dtype, device) -> torch.Tensor:
    """A small constant vector on ``device`` made by fill kernels: a copy
    from the host would wait for the card's queue to drain."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def segment_ranks(keys: torch.Tensor, valid: torch.Tensor):
    """Per row of (B, N) keys sorted along the row: each entry's rank among
    the row's distinct valid keys (0-based; runs of one key share a rank)
    and whether it starts its run."""
    prev = torch.cat([torch.full_like(keys[:, :1], -1), keys[:, :-1]], dim=1)
    first = (keys != prev) & valid
    return torch.cumsum(first, dim=1, dtype=torch.int32) - 1, first


def padded_width(n: torch.Tensor, capacity: int) -> int:
    """The largest of the per-sample counts ``n`` (B,), each at most
    ``capacity``: the padded width of a batched set, read from the card
    (the one wait of a build).  While ``torch.export`` traces, the width is
    ``capacity`` itself (the JAX package's static shape): the rows past a
    sample's count are padding, masked as they are at any width, so the
    result is the same."""
    if exporting():
        return capacity
    with profiling.wait('padded_width'):
        return int(n.max()) if n.numel() else 0


def key_set(keys: torch.Tensor, mask: torch.Tensor,
            shape: Tuple[int, int, int]):
    """(coords, keys, mask) of a padded (B, V) key set: sentinel keys and
    zero coords where ``mask`` is False."""
    k = torch.where(mask, keys, shape[0] * shape[1] * shape[2])
    coords = torch.where(mask[..., None], key_to_coords(k, shape), 0)
    return coords, k.to(torch.int32), mask


def voxelize_mean(points: torch.Tensor, valid: torch.Tensor,
                  point_cloud_range, voxel_size,
                  shape: Tuple[int, int, int], capacity: int) -> SparseVoxels:
    """Mean voxelization of (B, P, C) padded clouds; valid (B, P) bool.

    Voxel features are the mean of the full point vectors (the reference's
    ``scatter_mean`` over the 5-dim points), float32.  One sort of each
    cloud by key (a batched sort along the points), per-sample voxel ranks
    by a prefix count, the capacity cut on those ranks, and float64 sums
    scattered into (B, V) rows, with dump rows for cut and invalid points.
    """
    dev = points.device
    B, P, C = points.shape
    pcr_min = device_vector(point_cloud_range[:3], torch.float32, dev)
    vsize = device_vector(voxel_size, torch.float32, dev)
    pts = points.float()
    coord = torch.floor((pts[..., :3] - pcr_min) / vsize).to(torch.int32)
    ok = valid.clone()
    for axis in range(3):
        ok &= (coord[..., axis] >= 0) & (coord[..., axis] < shape[axis])
    key, order = torch.sort(coords_to_key(coord, shape, ok), dim=1,
                            stable=True)
    ok = torch.gather(ok, 1, order)
    vid, first = segment_ranks(key, ok)
    n = torch.clamp(first.sum(dim=1), max=capacity)
    V = padded_width(n, capacity)
    # cut and invalid points go to P dump rows past the B*V voxel rows, one
    # per position, so no single row takes the scattered writes of a batch
    dump = B * V + torch.arange(P, device=dev)
    row = torch.where(ok & (vid < capacity),
                      torch.arange(B, device=dev)[:, None] * V + vid, dump)
    row = row.reshape(-1)
    pts = torch.gather(pts, 1, order[..., None].expand(B, P, C))
    sums = torch.zeros(B * V + P, C, dtype=torch.float64, device=dev)
    sums.index_add_(0, row, pts.reshape(-1, C).double())
    cnt = torch.zeros(B * V + P, dtype=torch.float64, device=dev)
    cnt.index_add_(0, row, torch.ones_like(row, dtype=torch.float64))
    vkeys = torch.zeros(B * V + P, dtype=torch.int32, device=dev)
    vkeys[torch.where(first, row.view(B, P), dump)] = key
    mask = torch.arange(V, device=dev) < n[:, None]
    feats = (sums[:B * V] / cnt[:B * V].clamp_min(1)[:, None]).float()
    feats = torch.where(mask[..., None], feats.view(B, V, C), 0)
    return SparseVoxels(feats, *key_set(vkeys[:B * V].view(B, V), mask,
                                        shape))
