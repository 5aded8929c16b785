"""The plane-sweep stereo cost volume (BEVDet's ``gen_grid`` and
``calculate_cost_volumn``).

Every hypothesis (camera n, depth plane d, pixel y, x) of the key frame's
frustum is un-projected, moved into the previous (sweep) camera and
re-projected (``stereo_grid``); the previous frame's stage-0 feature is
sampled there bilinearly with zeros outside, and the L1 distance to the key
frame's feature, summed over the channels, is the matching cost; where the
sample of channel C - ``group_size`` (the first of BEVDet's last channel
group) is exactly 0 the invalid ``bias`` is added; the volume is the
softmax over the planes of minus the cost (``plane_sweep``), float32.

The geometry is split in two.  ``sweep_geometry`` composes, once a call and
per camera, the pieces of ``stereo_grid``'s chain (the inverse
post-rotation, rot · intrins⁻¹, the translation, intrins, the 2x2
post-rotation and the post-translation) into ``SweepGeometry.cams``;
``stereo_grid`` is ``sweep_grid`` on that, the (B*N, D*H, W, 2) grid.

The sweep is the custom op ``fusionocc::plane_sweep`` (``plane_sweep_op``)
on a ``SweepGeometry``: its CPU implementation is the plain version,
``plane_sweep`` on ``sweep_grid`` (C / ``group_size`` channel groups of
``grid_sample``, ``sub``, ``abs`` and ``sum``); its CUDA one launches
``csrc/plane_sweep.cu`` (``plane_sweep_cuda``), which projects each
hypothesis in the same chain and order in float32, samples, sums and takes
the softmax without writing the grid or any intermediate.  Only the order
of the float32 sums differs (a tap outside the map weighs 0 there, which
for finite features is grid_sample's skipped tap).  The kernel reads the
frustum's three axes (``make_frustum``'s grid is the product of a depth, a
row and a column axis).  The path follows the tensors' device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .grid_sample import grid_sample_2d
from .kernels import KERNELS, stream_ptr

# the words of ``SweepGeometry.cams`` per camera, float32, in this order:
# post_trans (3), the inverse post-rotation (3x3), rot · intrins⁻¹ (3x3),
# the translation (3), intrins (3x3), the post-rotation's 2x2 block
CAM_WORDS = 37
_PIECES = (('post_trans', 3), ('inv_post', 9), ('combine', 9), ('tra', 3),
           ('intrins', 9), ('post_rot2', 4))


class SweepGeometry(NamedTuple):
    """What a plane sweep needs of the cameras: the frustum (D, H, W, 3) of
    (u, v, d) in input-image pixels at the volume's resolution, the
    per-camera pieces (B*N, ``CAM_WORDS``) float32, and the input image's
    (hi, wi), over which the grid is normalised."""
    frustum: torch.Tensor
    cams: torch.Tensor
    hi: int
    wi: int


def sweep_geometry(frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                   intrins: torch.Tensor, post_rots: torch.Tensor,
                   post_trans: torch.Tensor, hi: int, wi: int
                   ) -> SweepGeometry:
    """Compose the per-camera pieces of the sweep's projection.

    ``k2s_sensor`` (B, N, 4, 4) maps the current camera into the previous
    (sweep) one; ``intrins``, ``post_rots`` (B, N, 3, 3), ``post_trans``
    (B, N, 3).  The inverses are ``inv_ex``: the host never waits on the
    card here."""
    f32 = torch.float32
    B, N = post_trans.shape[:2]
    intrins = intrins.to(f32)
    inv_post = torch.linalg.inv_ex(post_rots.to(f32))[0]
    combine = torch.einsum('bnij,bnjk->bnik', k2s_sensor[..., :3, :3].to(f32),
                           torch.linalg.inv_ex(intrins)[0])
    cams = torch.cat([post_trans.to(f32), inv_post.flatten(-2),
                      combine.flatten(-2), k2s_sensor[..., :3, 3].to(f32),
                      intrins.flatten(-2),
                      post_rots[..., :2, :2].to(f32).flatten(-2)], -1)
    return SweepGeometry(frustum, cams.reshape(B * N, CAM_WORDS), hi, wi)


def _pieces(cams: torch.Tensor) -> dict:
    out, at = {}, 0
    for name, n in _PIECES:
        piece = cams[:, at:at + n]
        out[name] = piece.reshape(-1, 3, 3) if n == 9 else (
            piece.reshape(-1, 2, 2) if n == 4 else piece)
        at += n
    return out


def sweep_grid(geom: SweepGeometry) -> torch.Tensor:
    """The sampling grid (B*N, D*H, W, 2) of (x, y), float32: every (d, u,
    v) of the frustum un-projected, moved, re-projected and normalised over
    the (hi, wi) image with ``align_corners=True``; points behind the sweep
    camera (z < 1e-3) at -2."""
    frustum, hi, wi = geom.frustum, geom.hi, geom.wi
    D, H, W, _ = frustum.shape
    c = _pieces(geom.cams)
    BN = geom.cams.shape[0]
    pts = (frustum.to(torch.float32)[None]
           - c['post_trans'][:, None, None, None, :])
    pts = torch.einsum('nij,ndhwj->ndhwi', c['inv_post'], pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    pts = torch.einsum('nij,ndhwj->ndhwi', c['combine'], pts)
    pts = pts + c['tra'][:, None, None, None, :]
    neg = pts[..., 2] < 1e-3
    pts = torch.einsum('nij,ndhwj->ndhwi', c['intrins'], pts)
    uv = pts[..., :2] / torch.clamp_min(pts[..., 2:3], 1e-6)
    uv = torch.einsum('nij,ndhwj->ndhwi', c['post_rot2'], uv)
    uv = uv + c['post_trans'][:, None, None, None, :2]
    px = uv[..., 0] / (wi - 1.0) * 2.0 - 1.0
    py = uv[..., 1] / (hi - 1.0) * 2.0 - 1.0
    px = torch.where(neg, -2.0, px)
    py = torch.where(neg, -2.0, py)
    return torch.stack([px, py], -1).reshape(BN, D * H, W, 2)


def stereo_grid(frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                intrins: torch.Tensor, post_rots: torch.Tensor,
                post_trans: torch.Tensor, hi: int, wi: int) -> torch.Tensor:
    """The plane sweep's sampling grid (BEVDet's ``gen_grid``), float32,
    (B*N, D*H, W, 2): ``sweep_grid`` of ``sweep_geometry``."""
    return sweep_grid(sweep_geometry(frustum, k2s_sensor, intrins, post_rots,
                                     post_trans, hi, wi))


def plane_sweep(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
                grid: torch.Tensor, depth_bins: int, group_size: int = 4,
                bias: float = 0.0) -> torch.Tensor:
    """The plane sweep on a ``stereo_grid``, in float32 (BEVDet's
    ``calculate_cost_volumn``), the plain version.

    prev/curr_feat (B*N, H, W, C) stage-0 features at the grid's
    resolution.  For each group of ``group_size`` channels the previous
    feature is sampled at the grid (bilinear, zeros outside) and the L1
    distance to the current feature over the group is added to the cost;
    where the first channel of the last group's sample is exactly 0 (as
    BEVDet reads its loop's last ``wrap_prev``) ``bias`` is added.  Returns
    softmax over depth of -cost, (B*N, D, H, W).
    """
    BN, H, W, C = curr_feat.shape
    D = depth_bins
    f32 = torch.float32
    cost = torch.zeros(BN, D, H, W, dtype=f32, device=curr_feat.device)
    for g in range(0, C, group_size):
        prev_g = prev_feat[..., g:g + group_size].permute(0, 3, 1, 2)
        warp = grid_sample_2d(prev_g.to(f32), grid)     # (BN, gs, D*H, W)
        warp = warp.reshape(BN, -1, D, H, W)
        curr_g = curr_feat[..., g:g + group_size].permute(0, 3, 1, 2)
        cost = cost + (curr_g[:, :, None].to(f32) - warp).abs().sum(dim=1)
    if bias:
        cost = cost + bias * (warp[:, 0] == 0)
    return torch.softmax(-cost, dim=1)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_PLANES = 128


def plane_sweep_cuda(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
                     frustum: torch.Tensor, cams: torch.Tensor, hi: int,
                     wi: int, group_size: int, bias: float,
                     invalid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``plane_sweep_fwd``: (B*N, D, H, W) float32 from prev/curr
    (B*N, H, W, C) in fp32 or bf16 (C 64 or 128), the frustum (D, H, W, 3)
    and ``cams`` (B*N, ``CAM_WORDS``).  ``invalid``, a (B*N, D, H, W) uint8
    tensor, receives the bias mask of each hypothesis (a check's; the main
    path passes none)."""
    dev = curr_feat.device
    if dev.type != 'cuda':
        raise ValueError(f'plane_sweep_cuda needs CUDA tensors, got {dev}')
    BN, H, W, C = curr_feat.shape
    D = frustum.shape[0]
    if prev_feat.shape != curr_feat.shape or prev_feat.dtype != \
            curr_feat.dtype or curr_feat.dtype not in _DTYPES:
        raise ValueError(f'prev and curr must be one shape and fp32 or bf16, '
                         f'got {tuple(prev_feat.shape)} {prev_feat.dtype}, '
                         f'{tuple(curr_feat.shape)} {curr_feat.dtype}')
    if C not in (64, 128):
        raise ValueError(f'plane_sweep_cuda takes 64 or 128 channels, got {C}')
    if frustum.shape != (D, H, W, 3) or not 0 < D <= _MAX_PLANES:
        raise ValueError(f'frustum {tuple(frustum.shape)} does not fit the '
                         f'features {tuple(curr_feat.shape)} (at most '
                         f'{_MAX_PLANES} planes)')
    if cams.shape != (BN, CAM_WORDS):
        raise ValueError(f'cams {tuple(cams.shape)}, expected '
                         f'({BN}, {CAM_WORDS})')
    if not 0 < group_size <= C or min(H, W) < 2:
        raise ValueError(f'group_size {group_size} for {C} channels, or a '
                         f'map of {H}x{W} (the kernel takes 2x2 and up)')
    # the channel whose zero sample takes the bias: the last group's first
    bias_ch = (C - 1) // group_size * group_size
    if (BN * D * H * W) >= 2 ** 31 or BN * H * W * C >= 2 ** 31:
        raise ValueError('the volume or a feature exceeds int32 indexing')
    tensors = [t.contiguous() for t in (prev_feat, curr_feat)] + [
        t.to(torch.float32).contiguous() for t in (frustum, cams)]
    if any(t.device != dev for t in tensors):
        raise ValueError('every input must be on one device')
    if any(t.data_ptr() % 16 for t in tensors[:2]):
        raise ValueError('prev and curr must be 16-byte aligned')
    out = torch.empty(BN, D, H, W, dtype=torch.float32, device=dev)
    if invalid is not None and (invalid.shape != out.shape or invalid.dtype
                                != torch.uint8 or invalid.device != dev
                                or not invalid.is_contiguous()):
        raise ValueError('invalid must be a contiguous uint8 (B*N, D, H, W) '
                         f'tensor on {dev}')
    with torch.cuda.device(dev):
        KERNELS.launch('plane_sweep_fwd', *(t.data_ptr() for t in tensors),
                       out.data_ptr(),
                       None if invalid is None else invalid.data_ptr(),
                       BN, D, H, W, C, hi, wi, bias_ch, float(bias),
                       _DTYPES[curr_feat.dtype], stream_ptr(dev))
    return out


@torch.library.custom_op('fusionocc::plane_sweep', mutates_args=(),
                         device_types='cpu')
def plane_sweep_op(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
                   frustum: torch.Tensor, cams: torch.Tensor, hi: int,
                   wi: int, group_size: int, bias: float) -> torch.Tensor:
    """The plane sweep as a custom op on a ``SweepGeometry``'s tensors: on
    the CPU the plain version, ``plane_sweep`` on ``sweep_grid``."""
    grid = sweep_grid(SweepGeometry(frustum, cams, hi, wi))
    return plane_sweep(prev_feat, curr_feat, grid, frustum.shape[0],
                       group_size, bias)


@plane_sweep_op.register_kernel('cuda')
def _plane_sweep_op_cuda(prev_feat, curr_feat, frustum, cams, hi, wi,
                         group_size, bias):
    return plane_sweep_cuda(prev_feat, curr_feat, frustum, cams, hi, wi,
                            group_size, bias)


@plane_sweep_op.register_fake
def _plane_sweep_op_fake(prev_feat, curr_feat, frustum, cams, hi, wi,
                         group_size, bias):
    BN, H, W, _ = curr_feat.shape
    return curr_feat.new_empty(BN, frustum.shape[0], H, W,
                               dtype=torch.float32)


def sweep(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
          geom: SweepGeometry, group_size: int = 4,
          bias: float = 0.0) -> torch.Tensor:
    """The plane sweep of prev/curr (B*N, H, W, C) on ``geom``: (B*N, D, H,
    W) float32; the plain version for CPU tensors, the kernel otherwise."""
    return plane_sweep_op(prev_feat, curr_feat, geom.frustum, geom.cams,
                          geom.hi, geom.wi, group_size, bias)
