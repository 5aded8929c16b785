"""Dynamic voxelization: padded point clouds -> sorted unique voxels.

Port of ``fusionocc_tpu/ops/voxelize.py``.  Conventions shared by the
port's sparse stack (``ops/zfold.py``, ``ops/sparse_conv.py``):

- voxel key = (x * SY + y) * SZ + z, int32, ascending per sample (the order
  ``torch.unique`` gives);
- a sample keeps its first ``capacity`` keys ascending, the JAX package's
  static-capacity cut, so both packages hold the same set when a cloud
  overflows;
- sets have their own size: a batch is padded to its largest sample, not to
  the capacity.  Padded rows carry the sentinel key SX*SY*SZ, zero coords
  and features, and mask False.

Points are binned with ``floor`` in fp32 exactly as the JAX package does.
The mean is an exact segment mean: each voxel's few points are summed in
float64 and divided once.  (The JAX package differences fp32 prefix sums
over the whole sorted cloud instead, which is 9.37e-2 m off on the
full-size synthetic cloud; tests/test_torch_lidar_ops.py, ROADMAP Queue C.)
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


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


def pad_stack(rows: Sequence[torch.Tensor], fill) -> torch.Tensor:
    """Stack per-sample tensors of different lengths along a new batch
    axis, padding each to the longest with ``fill``."""
    n = max(r.shape[0] for r in rows)
    out = rows[0].new_full((len(rows), n) + tuple(rows[0].shape[1:]), fill)
    for b, r in enumerate(rows):
        out[b, :r.shape[0]] = r
    return out


def key_set(keys: List[torch.Tensor], shape: Tuple[int, int, int]):
    """Pad per-sample sorted (n_b,) int32 keys: (coords, keys, mask)."""
    k = pad_stack(keys, shape[0] * shape[1] * shape[2])
    mask = pad_stack([torch.ones_like(x, dtype=torch.bool) for x in keys],
                     False)
    coords = torch.where(mask[..., None], key_to_coords(k, shape), 0)
    return coords, k, mask


def voxelize_mean(points: torch.Tensor, valid: torch.Tensor,
                  point_cloud_range, voxel_size,
                  shape: Tuple[int, int, int], capacity: int) -> SparseVoxels:
    """Mean voxelization of (B, P, C) padded clouds; valid (B, P) bool.

    Voxel features are the mean of the full point vectors (the reference's
    ``scatter_mean`` over the 5-dim points), float32.
    """
    dev = points.device
    pcr_min = torch.tensor(point_cloud_range[:3], dtype=torch.float32,
                           device=dev)
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    pts = points.float()
    coord = torch.floor((pts[..., :3] - pcr_min) / vsize).to(torch.int32)
    hi = torch.tensor(shape, dtype=torch.int32, device=dev)
    ok = valid & ((coord >= 0) & (coord < hi)).all(dim=-1)
    key = coords_to_key(coord, shape, ok)
    feats, keys = [], []
    for b in range(points.shape[0]):
        k, p = key[b][ok[b]], pts[b][ok[b]]
        uniq, inv, cnt = torch.unique(k, sorted=True, return_inverse=True,
                                      return_counts=True)
        n = min(uniq.shape[0], capacity)
        sums = torch.zeros(uniq.shape[0], p.shape[1], dtype=torch.float64,
                           device=dev).index_add_(0, inv, p.double())
        feats.append((sums[:n] / cnt[:n, None]).float())
        keys.append(uniq[:n].to(torch.int32))
    return SparseVoxels(pad_stack(feats, 0), *key_set(keys, shape))
