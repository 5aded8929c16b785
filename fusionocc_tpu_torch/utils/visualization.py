"""Occupancy visualization (matplotlib; Open3D used when available).

The port's copy of ``fusionocc_tpu/utils/visualization.py``: the same
palette, the same north-up BEV image and the same lazy imports (matplotlib
inside ``save_occupancy_figure``, Open3D optional).  Equivalent of the
reference's visualizer/occupancy_visualizer.py and FusionOCC.show_results
(fusion_occ.py:922-1140): color-coded BEV projection of a (X, Y, Z)
class-id grid, plus an optional Open3D voxel scene.  Inputs are numpy
arrays (``tensor.cpu().numpy()`` of a prediction).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Occ3D-nuScenes palette (class order occ_metrics.py:51-54)
OCC_COLORS = np.array([
    [0, 0, 0],        # others
    [255, 120, 50],   # barrier
    [255, 192, 203],  # bicycle
    [255, 255, 0],    # bus
    [0, 150, 245],    # car
    [0, 255, 255],    # construction_vehicle
    [255, 127, 0],    # motorcycle
    [255, 0, 0],      # pedestrian
    [255, 240, 150],  # traffic_cone
    [135, 60, 0],     # trailer
    [160, 32, 240],   # truck
    [255, 0, 255],    # driveable_surface
    [139, 137, 137],  # other_flat
    [75, 0, 75],      # sidewalk
    [150, 240, 80],   # terrain
    [230, 230, 250],  # manmade
    [0, 175, 0],      # vegetation
    [255, 255, 255],  # free
], dtype=np.uint8)


def occupancy_bev_image(occ: np.ndarray, free_class: int = 17) -> np.ndarray:
    """(X, Y, Z) class grid -> (Y, X, 3) uint8 BEV image (topmost non-free
    voxel wins, mirroring the reference's BEV dump)."""
    occ = np.asarray(occ)
    X, Y, Z = occ.shape
    img = np.full((X, Y), free_class, occ.dtype)
    for z in range(Z):           # low to high; higher voxels overwrite
        layer = occ[:, :, z]
        sel = layer != free_class
        img[sel] = layer[sel]
    return OCC_COLORS[np.transpose(img)][::-1]  # north-up


def save_occupancy_figure(occ: np.ndarray, path: str,
                          gt: Optional[np.ndarray] = None,
                          title: str = 'occupancy') -> str:
    """Save a BEV (and optional GT comparison) PNG."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    n = 2 if gt is not None else 1
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 6))
    axes = np.atleast_1d(axes)
    axes[0].imshow(occupancy_bev_image(occ))
    axes[0].set_title(f'{title} (pred)')
    if gt is not None:
        axes[1].imshow(occupancy_bev_image(gt))
        axes[1].set_title(f'{title} (gt)')
    for ax in axes:
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def occupancy_to_open3d(occ: np.ndarray, voxel_size: float = 0.4,
                        origin: Sequence[float] = (-40.0, -40.0, -1.0),
                        free_class: int = 17):
    """Open3D voxel grid of the occupied cells (None if open3d missing)."""
    try:
        import open3d as o3d
    except ImportError:
        return None
    xs, ys, zs = np.nonzero(occ != free_class)
    pts = (np.stack([xs, ys, zs], 1) + 0.5) * voxel_size + np.asarray(origin)
    colors = OCC_COLORS[occ[xs, ys, zs]] / 255.0
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(pts)
    pc.colors = o3d.utility.Vector3dVector(colors)
    return o3d.geometry.VoxelGrid.create_from_point_cloud(pc, voxel_size)
