"""The LSS view transformer's camera geometry: the frustum template, its
points in the key ego frame, and the 27-number camera vector."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_frustum(depth_cfg: Tuple[float, float, float],
                 input_size: Tuple[int, int],
                 downsample: int,
                 sid: bool = False,
                 device: torch.device | str = 'cpu') -> torch.Tensor:
    """Frustum template (D, Hf, Wf, 3) of (u, v, d) in input-image pixels.

    Depth bins are an arange over [lo, hi) with the given step (log-spaced
    when ``sid``); pixel centres are linspace(0, size-1, feat).
    """
    h_in, w_in = input_size
    h_feat, w_feat = h_in // downsample, w_in // downsample
    d = np.arange(depth_cfg[0], depth_cfg[1], depth_cfg[2], dtype=np.float32)
    num_d = d.shape[0]
    if sid:
        idx = np.arange(num_d, dtype=np.float32)
        lo, hi, _ = depth_cfg
        d = np.exp(np.log(lo) + idx / (num_d - 1) * np.log((hi - 1.0) / lo))
    d = np.broadcast_to(d[:, None, None], (num_d, h_feat, w_feat))
    x = np.linspace(0, w_in - 1, w_feat, dtype=np.float32)
    x = np.broadcast_to(x[None, None, :], (num_d, h_feat, w_feat))
    y = np.linspace(0, h_in - 1, h_feat, dtype=np.float32)
    y = np.broadcast_to(y[None, :, None], (num_d, h_feat, w_feat))
    frustum = np.stack([x, y, d], axis=-1).astype(np.float32)
    return torch.from_numpy(frustum).to(device)


def frustum_to_ego(frustum: torch.Tensor,
                   sensor2ego: torch.Tensor,
                   intrins: torch.Tensor,
                   post_rots: torch.Tensor,
                   post_trans: torch.Tensor,
                   bda: torch.Tensor) -> torch.Tensor:
    """Map the frustum template into (key-)ego coordinates.

    frustum: (D, Hf, Wf, 3); sensor2ego: (B, N, 4, 4); intrins, post_rots:
    (B, N, 3, 3); post_trans: (B, N, 3); bda: (B, 3, 3).
    Returns (B, N, D, Hf, Wf, 3) float32 ego-frame xyz.
    """
    f32 = torch.float32
    pts = (frustum.to(f32)[None, None]
           - post_trans.to(f32)[:, :, None, None, None, :])
    inv_post = torch.linalg.inv(post_rots.to(f32))
    pts = torch.einsum('bnij,bndhwj->bndhwi', inv_post, pts)
    # (u*d, v*d, d)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = torch.einsum('bnij,bnjk->bnik', sensor2ego[..., :3, :3].to(f32),
                           torch.linalg.inv(intrins.to(f32)))
    pts = torch.einsum('bnij,bndhwj->bndhwi', combine, pts)
    pts = pts + sensor2ego[..., :3, 3].to(f32)[:, :, None, None, None, :]
    return torch.einsum('bij,bndhwj->bndhwi', bda.to(f32), pts)


def get_mlp_input(sensor2keyego: torch.Tensor,
                  intrin: torch.Tensor,
                  post_rot: torch.Tensor,
                  post_tran: torch.Tensor,
                  bda: torch.Tensor) -> torch.Tensor:
    """27-dim camera parameter vector per view (B, N, 27).

    The pose argument is the KEY frame's sensor2keyego whichever temporal
    frame is being processed.
    """
    B, N = intrin.shape[:2]
    bda_ = bda[:, None].expand(B, N, 3, 3)
    feats = torch.stack([
        intrin[:, :, 0, 0], intrin[:, :, 1, 1],
        intrin[:, :, 0, 2], intrin[:, :, 1, 2],
        post_rot[:, :, 0, 0], post_rot[:, :, 0, 1], post_tran[:, :, 0],
        post_rot[:, :, 1, 0], post_rot[:, :, 1, 1], post_tran[:, :, 1],
        bda_[:, :, 0, 0], bda_[:, :, 0, 1],
        bda_[:, :, 1, 0], bda_[:, :, 1, 1], bda_[:, :, 2, 2],
    ], dim=-1)
    pose = sensor2keyego[:, :, :3, :].reshape(B, N, 12)
    return torch.cat([feats, pose], dim=-1)
