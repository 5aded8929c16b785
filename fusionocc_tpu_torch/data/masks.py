"""Training-mask ablation modes for the occupancy loss.

The port's copy of ``fusionocc_tpu/data/masks.py``.  Re-implements the
reference's 7 mask_mode variants (transforms/loading.py:490-675): the
camera mask is a per-voxel binary loss weight; the distance-conditioned
modes force supervision for selected voxels (near/far occupied or free)
regardless of camera visibility.
"""
from __future__ import annotations

import numpy as np

MASK_MODES = ('baseline_with_mask', 'baseline_without_mask', 'condition_C',
              'condition_D', 'condition_D_prime', 'condition_D_full',
              'condition_C_full')


def build_training_mask(semantics: np.ndarray, mask_camera: np.ndarray,
                        mode: str = 'baseline_with_mask',
                        free_class_id: int = 17,
                        dist_threshold_c: float = 35.0,
                        dist_threshold_d: float = 20.0,
                        dist_threshold_d_prime: float = 35.0,
                        pc_range_x: float = 80.0) -> np.ndarray:
    """Return the (possibly modified) camera mask for the given ablation mode.

    semantics/mask_camera: (X, Y, Z). Distances are planar (x, y) metres from
    the grid center (the ego).
    """
    if mode not in MASK_MODES:
        raise ValueError(f'unknown mask mode {mode!r}; one of {MASK_MODES}')
    if mode == 'baseline_with_mask':
        return mask_camera
    if mode == 'baseline_without_mask':
        return np.ones_like(mask_camera)

    out = mask_camera.copy()
    X, Y, Z = semantics.shape
    voxel = pc_range_x / X
    dx = (np.arange(X) - (X - 1) / 2.0) * voxel
    dy = (np.arange(Y) - (Y - 1) / 2.0) * voxel
    dist = np.sqrt(dx[:, None] ** 2 + dy[None, :] ** 2)[:, :, None]
    dist = np.broadcast_to(dist, (X, Y, Z))

    free = semantics == free_class_id
    occupied = ~free
    force = {
        'condition_C': occupied & (dist < dist_threshold_c),
        'condition_D': free & (dist < dist_threshold_d),
        'condition_D_prime': free & (dist < dist_threshold_d_prime),
        'condition_D_full': free,
        'condition_C_full': occupied,
    }[mode]
    out[force] = 1
    return out
