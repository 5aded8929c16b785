"""BEVFormer-Occ: BEVFormer (Li et al., ECCV 2022, arXiv:2203.17270) as
Occ3D (Tian et al., arXiv:2304.14365) trains it for occupancy, the
baseline of Occ3D-nuScenes (``bevformer_base_occ.py`` of the challenge
repository), beside ``OccModel`` rather than under it: it shares no module
of FusionOcc's camera branch or trunk.

A frame: six images padded to a multiple of 32 through a caffe-style
ResNet-101 with DCNv2 in stages 3 and 4 (``nn/resnet.py``; span
``camera.backbone``) and the FPN to four levels of 256 channels (span
``camera.neck``), flattened with camera and level embeddings; 200 x 200
learned BEV queries plus the can-bus MLP's embedding, with a learned row
and column positional encoding, through six encoder layers (span
``bev.encoder``) of temporal self-attention (span ``bev.tsa``), LayerNorm,
spatial cross-attention (``bev.sca``), LayerNorm, FFN (``bev.ffn``),
LayerNorm; the head (span ``head``): Linear 256 -> 512, Softplus, Linear
-> 16 x 32 per BEV cell, then the predicter 32 -> 64 -> 18 per voxel.

Temporal self-attention samples two BEV frames, each at 4 points a head
(``ops/ms_deform_attn.py``), with offsets and weights from [previous BEV
or own query, query + position], and averages them.  The previous frame's
BEV comes rotated by the ego yaw change about the BEV's centre (nearest,
zeros outside: torchvision's ``rotate`` default, here an ``affine_grid``
and ``grid_sample``; span ``stream.rotate``), and every frame's 2D
reference points are shifted by the ego translation (BEVFormer shifts
both frames' points: its ``shift_ref_2d = ref_2d`` aliases them, kept in
the paper's results).  At a scene start, or where ``reset`` is set, the
can-bus deltas are 0 and the previous BEV is the layer's own query, so the
attention's values are [query, query]; otherwise they are [rotated
previous BEV, the encoder's input queries], in every layer, as BEVFormer's
encoder stacks them.  The can-bus vector: the translation since the last
frame (global frame), the ego rotation as a quaternion, zero acceleration
and rotation rate, the velocity in the ego frame from the translation over
``frame_interval_s``, the yaw in radians in [0, 2 pi) and its change in
degrees since the last frame; it and its MLP are computed in float32.

Spatial cross-attention projects 4 pillar anchors a BEV cell (z over the
grid's range) into every camera; each camera attends only to the queries
one of whose anchors it sees (``RigIndex``: the queries re-batched per
camera, padded to the most any camera sees), at 8 points a head and level,
2 per anchor; the outputs are summed back per query and divided by the
number of cameras that see it.  The index depends only on the rig, so the
caller builds it once (``rig_index``, span ``bev.sca.rebatch``, one host
read: the wait ``sca.rebatch``) and a streamed frame then makes no host
wait at all.

Parameters are float32; compute is in ``cfg.dtype`` (Linear and Conv in
the input's dtype, LayerNorm, softmax, the samples' sums and the re-batch
sums in float32).  BEVFormer's own sizes are ``config.BEVFormerConfig``;
the model's grid, cameras, input size and classes are the
``ModelConfig``'s.  Inference only: ``predict`` (one frame, no history)
and ``predict_streaming``; the logits come as (B, X, Y, Z, classes), the
port's layout (BEVFormer's head gives (B, Y, X, Z, classes)).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BEVFormerConfig, ModelConfig
from ..nn.layers import LayerNorm, Linear
from ..nn.resnet import FPN, ResNet
from ..ops.ms_deform_attn import ms_deform_attn
from ..utils import profiling
from .fusion_occ import Batch, OccModel, _inference

EPS = 1e-5      # BEVFormer's least camera depth of a projected anchor
CAN_BUS = 18    # the can-bus vector's entries (``can_bus``)


class BEVState(NamedTuple):
    """The streaming state: the previous frame's BEV (the encoder's
    output), its ego pose, and whether it is valid (False at scene
    starts)."""
    prev_bev: torch.Tensor      # (B, bev_h * bev_w, C) in cfg.dtype
    ego2global: torch.Tensor    # (B, 4, 4) float32
    valid: torch.Tensor         # (B,) bool


class RigIndex(NamedTuple):
    """Spatial cross-attention's re-batch for one rig: per camera the
    queries it sees (any anchor), in query order, padded with the index Q
    (a row that is dropped), their anchors' image coordinates, and per
    query the number of cameras that see it (at least 1)."""
    query_idx: torch.Tensor     # (N, Lmax) int64
    ref_cam: torch.Tensor       # (N, Lmax, D, 2) float32, (x, y) in [0, 1]
    count: torch.Tensor         # (Q,) float32


def level_shapes(input_size: Tuple[int, int], pad: int, first: int,
                 levels: int) -> List[Tuple[int, int]]:
    """The FPN levels' (h, w): the padded input halved, rounding up, at
    the stem's conv and pool and at each later stage, the first level
    after ``first`` halvings, then once a level."""
    h, w = (-(-s // pad) * pad for s in input_size)
    out = []
    for i in range(first + levels):
        h, w = -(-h // 2), -(-w // 2)
        if i >= first:
            out.append((h, w))
    return out


def pillar_points(model: ModelConfig, anchors: int) -> torch.Tensor:
    """(D, Q, 3) ego coordinates of the BEV cells' pillar anchors, query
    index h * W + w (h along y, w along x); z at (linspace(0.5, Z - 0.5,
    D) / Z) of the grid's height Z (BEVFormer's ``get_reference_points``)."""
    g = model.grid
    W, H, _ = g.grid_size
    Z = g.z[1] - g.z[0]
    zs = torch.linspace(0.5, Z - 0.5, anchors) / Z
    xs = torch.linspace(0.5, W - 0.5, W) / W
    ys = torch.linspace(0.5, H - 0.5, H) / H
    p = torch.stack([xs.view(1, 1, W).expand(anchors, H, W),
                     ys.view(1, H, 1).expand(anchors, H, W),
                     zs.view(anchors, 1, 1).expand(anchors, H, W)], -1)
    lo = torch.tensor([g.x[0], g.y[0], g.z[0]])
    span = torch.tensor([g.x[1] - g.x[0], g.y[1] - g.y[0], Z])
    return (p * span + lo).view(anchors, H * W, 3)


def lidar2img(s2e, intrins, post_rots, post_trans) -> torch.Tensor:
    """(..., N, 4, 4): ego point to (u z, v z, z, 1) of the augmented image
    (the ego frame stands for BEVFormer's LiDAR frame)."""
    R, t = s2e[..., :3, :3], s2e[..., :3, 3:]
    e2s = torch.zeros_like(s2e)
    e2s[..., :3, :3] = R.transpose(-1, -2)
    e2s[..., :3, 3:] = -R.transpose(-1, -2) @ t
    e2s[..., 3, 3] = 1
    K = torch.zeros_like(s2e)
    K[..., :3, :3] = intrins
    K[..., 3, 3] = 1
    A = torch.zeros_like(s2e)
    A[..., :2, :2] = post_rots[..., :2, :2]
    A[..., :2, 2] = post_trans[..., :2]
    A[..., 2, 2] = A[..., 3, 3] = 1
    return A @ K @ e2s


def project(points: torch.Tensor, l2i: torch.Tensor, img_hw
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (D, Q, 3), l2i (N, 4, 4) -> (N, Q, D, 2) image coordinates
    over the padded image's (W, H) and the (N, Q, D) mask of those in
    front of the camera (depth above ``EPS``) and inside (0, 1)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    cam = torch.einsum('nij,dqj->nqdi', l2i, p)
    z = cam[..., 2:3]
    uv = cam[..., :2] / torch.maximum(z, torch.full_like(z, EPS))
    uv = torch.stack([uv[..., 0] / img_hw[1], uv[..., 1] / img_hw[0]], -1)
    mask = ((z[..., 0] > EPS) & (uv[..., 0] > 0) & (uv[..., 0] < 1)
            & (uv[..., 1] > 0) & (uv[..., 1] < 1))
    return uv, mask


class MSDASampling(nn.Module):
    """One attention's sampling, ``ms_deform_attn`` alone, over its fixed
    level shapes (a module so that a clock can hook it)."""

    def __init__(self, shapes: Sequence[Tuple[int, int]]):
        super().__init__()
        self.shapes = [tuple(s) for s in shapes]

    def forward(self, value, locations, weights):
        return ms_deform_attn(value, self.shapes, locations, weights)


class TemporalSelfAttention(nn.Module):
    """BEVFormer's ``TemporalSelfAttention``: 2 BEV frames, 1 level."""

    def __init__(self, c: int, heads: int, points: int, bev_hw):
        super().__init__()
        self.heads, self.points = heads, points
        self.sampling_offsets = Linear(2 * c, 2 * heads * points * 2)
        self.attention_weights = Linear(2 * c, 2 * heads * points)
        self.value_proj = Linear(c, c)
        self.output_proj = Linear(c, c)
        self.sampling = MSDASampling([bev_hw])
        h, w = bev_hw
        self.register_buffer('normalizer', torch.tensor([w, h]).float(),
                             persistent=False)

    def forward(self, query, pos, v0, v1, ref2d):
        """query, pos, v0 (previous BEV or query), v1 (the encoder's input
        queries or query): (B, Q, C); ref2d (B, Q, 2)."""
        B, Q, C = query.shape
        H, P = self.heads, self.points
        q = torch.cat([v0, query + pos], -1)
        value = self.value_proj(torch.stack([v0, v1], 1).view(B * 2, Q, C))
        off = self.sampling_offsets(q).view(B, Q, H, 2, 1, P, 2)
        off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * 2, Q, H, 1, P, 2)
        w = self.attention_weights(q).view(B, Q, H, 2, P).float().softmax(-1)
        w = w.permute(0, 3, 1, 2, 4).reshape(B * 2, Q, H, 1, P)
        ref = ref2d.repeat_interleave(2, dim=0)
        loc = ref[:, :, None, None, None, :] + off.float() / self.normalizer
        out = self.sampling(value.view(B * 2, Q, H, C // H), loc, w)
        out = out.view(B, 2, Q, C).mean(1).to(query.dtype)
        return self.output_proj(out) + query


class MSDeformableAttention3D(nn.Module):
    """BEVFormer's ``MSDeformableAttention3D``: ``points`` a head and
    level, ``points / anchors`` around each of a query's ``anchors``
    reference points (point k = i * anchors + anchor)."""

    def __init__(self, c: int, heads: int, shapes, points: int,
                 anchors: int):
        super().__init__()
        L = len(shapes)
        self.heads, self.levels, self.points = heads, L, points
        self.anchors = anchors
        self.sampling_offsets = Linear(c, heads * L * points * 2)
        self.attention_weights = Linear(c, heads * L * points)
        self.value_proj = Linear(c, c)
        self.sampling = MSDASampling(shapes)
        self.register_buffer(
            'normalizer', torch.tensor([[w, h] for h, w in shapes]).float(),
            persistent=False)

    def forward(self, query, value, ref):
        """query (M, Lq, C), value (M, S, C), ref (M, Lq, D, 2)."""
        M, Lq, C = query.shape
        H, L, P, D = self.heads, self.levels, self.points, self.anchors
        v = self.value_proj(value).view(M, value.shape[1], H, C // H)
        off = self.sampling_offsets(query).view(M, Lq, H, L, P // D, D, 2)
        off = off.float() / self.normalizer[:, None, None, :]
        loc = (ref[:, :, None, None, None] + off).view(M, Lq, H, L, P, 2)
        w = self.attention_weights(query).view(M, Lq, H, L * P).float()
        w = w.softmax(-1).view(M, Lq, H, L, P)
        return self.sampling(v, loc, w)


class SpatialCrossAttention(nn.Module):
    """BEVFormer's ``SpatialCrossAttention`` over a ``RigIndex``."""

    def __init__(self, c: int, heads: int, shapes, points: int,
                 anchors: int):
        super().__init__()
        self.deformable_attention = MSDeformableAttention3D(
            c, heads, shapes, points, anchors)
        self.output_proj = Linear(c, c)

    def forward(self, query, value, rig: RigIndex):
        """query (B, Q, C); value (B * N, S, C), camera-major per sample."""
        B, Q, C = query.shape
        N, Lm = rig.query_idx.shape
        idx = rig.query_idx.reshape(-1)
        rows = torch.cat([query, query.new_zeros(B, 1, C)], 1)[:, idx]
        ref = rig.ref_cam.expand(B, N, Lm, *rig.ref_cam.shape[2:])
        out = self.deformable_attention(
            rows.view(B * N, Lm, C), value,
            ref.reshape(B * N, Lm, *rig.ref_cam.shape[2:]))
        slots = query.new_zeros(B, Q + 1, C, dtype=torch.float32)
        slots.index_add_(1, idx, out.view(B, N * Lm, C))
        slots = slots[:, :Q] / rig.count[:, None]
        return self.output_proj(slots.to(query.dtype)) + query


class FFN(nn.Module):
    """mmcv's FFN with its identity: x + fc2(relu(fc1(x)))."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(Linear(c, hidden),
                                                  nn.ReLU()),
                                    Linear(hidden, c))

    def forward(self, x):
        return x + self.layers(x)


class EncoderLayer(nn.Module):
    """BEVFormer's ``BEVFormerLayer``: (TSA, norm, SCA, norm, FFN, norm)."""

    def __init__(self, bev: BEVFormerConfig, bev_hw, shapes):
        super().__init__()
        c = bev.embed_dims
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(c, bev.num_heads, bev.tsa_points, bev_hw),
            SpatialCrossAttention(c, bev.num_heads, shapes, bev.sca_points,
                                  bev.pillar_points)])
        self.norms = nn.ModuleList(LayerNorm(c, eps=1e-5) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(c, bev.ffn_dims)])

    def forward(self, q, pos, prev, q0, valid, ref2d, value, rig):
        keep = valid[:, None, None]
        with profiling.span('bev.tsa'):
            q = self.norms[0](self.attentions[0](
                q, pos, torch.where(keep, prev, q), torch.where(keep, q0, q),
                ref2d))
        with profiling.span('bev.sca'):
            q = self.norms[1](self.attentions[1](q, value, rig))
        with profiling.span('bev.ffn'):
            return self.norms[2](self.ffns[0](q))


class BEVEncoder(nn.Module):
    """The encoder's layers over the same inputs but the query."""

    def __init__(self, bev: BEVFormerConfig, bev_hw, shapes):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(bev, bev_hw, shapes)
                                    for _ in range(bev.num_layers))

    def forward(self, q0, pos, prev, valid, ref2d, value, rig: RigIndex):
        q = q0
        for layer in self.layers:
            q = layer(q, pos, prev, q0, valid, ref2d, value, rig)
        return q


class BEVEmbeddings(nn.Module):
    """The learned tables: BEV queries, the positional encoding's row and
    column halves (mmdet's ``LearnedPositionalEncoding``), the level and
    camera embeddings."""

    def __init__(self, c: int, bev_h: int, bev_w: int, levels: int,
                 cams: int):
        super().__init__()
        self.bev_queries = nn.Parameter(torch.zeros(bev_h * bev_w, c))
        self.row_embed = nn.Parameter(torch.zeros(bev_h, c // 2))
        self.col_embed = nn.Parameter(torch.zeros(bev_w, c // 2))
        self.level_embeds = nn.Parameter(torch.zeros(levels, c))
        self.cams_embeds = nn.Parameter(torch.zeros(cams, c))

    def position(self) -> torch.Tensor:
        """(H * W, C): [column embedding of w, row embedding of h]."""
        H, W = self.row_embed.shape[0], self.col_embed.shape[0]
        return torch.cat([self.col_embed[None].expand(H, W, -1),
                          self.row_embed[:, None].expand(H, W, -1)],
                         -1).view(H * W, -1)


def can_bus(pose, prev_pose, valid, dt: float) -> torch.Tensor:
    """(B, 18) float32, BEVFormer's test-time can-bus vector (module
    docstring); the deltas 0 where ``valid`` is False."""
    def yaw_deg(p):
        d = torch.rad2deg(torch.atan2(p[:, 1, 0], p[:, 0, 0]))
        return torch.where(d < 0, d + 360, d)
    keep = valid[:, None]
    deg = yaw_deg(pose)
    yaw = torch.deg2rad(deg)
    dpos = torch.where(keep, pose[:, :3, 3] - prev_pose[:, :3, 3], 0.0)
    vel = (pose[:, :3, :3].transpose(1, 2) @ dpos[..., None])[..., 0] / dt
    zero = torch.zeros_like(dpos)
    half = torch.atan2(pose[:, 1, 0], pose[:, 0, 0]) / 2
    quat = torch.stack([half.cos(), zero[:, 0], zero[:, 0], half.sin()], -1)
    turn = torch.where(valid, deg - yaw_deg(prev_pose), 0.0)
    return torch.cat([dpos, quat, zero, zero, vel, yaw[:, None],
                      turn[:, None]], -1)


def bev_shift(bus, grid, bev_h: int, bev_w: int) -> torch.Tensor:
    """(B, 2) the reference points' shift (x, y) in BEV units from the
    can-bus translation and yaw (BEVFormer's ``get_bev_features``)."""
    dx, dy = bus[:, 0], bus[:, 1]
    length = torch.sqrt(dx ** 2 + dy ** 2)
    angle = (torch.rad2deg(bus[:, 16])
             - torch.rad2deg(torch.atan2(dy, dx)))
    gy = (grid.y[1] - grid.y[0]) / bev_h
    gx = (grid.x[1] - grid.x[0]) / bev_w
    sy = length * torch.cos(torch.deg2rad(angle)) / gy / bev_h
    sx = length * torch.sin(torch.deg2rad(angle)) / gx / bev_w
    return torch.stack([sx, sy], -1)


def rotate_bev(bev: torch.Tensor, angle_deg: torch.Tensor, bev_h: int,
               bev_w: int) -> torch.Tensor:
    """(B, H*W, C) rotated by ``angle_deg`` (B,) about the map's centre,
    nearest, zeros outside: output pixel (x, y), centred, reads the input
    at (cos a x - sin a y, sin a x + cos a y), torchvision's ``rotate``."""
    B, Q, C = bev.shape
    a = torch.deg2rad(angle_deg.float())
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(c)
    theta = torch.stack([torch.stack([c, -s * bev_h / bev_w, z], -1),
                         torch.stack([s * bev_w / bev_h, c, z], -1)], 1)
    grid = F.affine_grid(theta, [B, C, bev_h, bev_w], align_corners=False)
    img = bev.float().transpose(1, 2).reshape(B, C, bev_h, bev_w)
    out = F.grid_sample(img, grid, mode='nearest', padding_mode='zeros',
                        align_corners=False)
    return out.reshape(B, C, Q).transpose(1, 2).to(bev.dtype)


class BEVFormerOcc(nn.Module):
    """BEVFormer-Occ on ``device`` (the card by default), float32
    parameters; ``bev`` its own sizes (the published ones by default)."""

    def __init__(self, cfg: ModelConfig, device='cuda',
                 bev: Optional[BEVFormerConfig] = None):
        super().__init__()
        bev = bev or BEVFormerConfig()
        self.cfg, self.bev = cfg, bev
        gx, gy, gz = cfg.grid.grid_size
        self.bev_h, self.bev_w = gy, gx
        c = bev.embed_dims
        pad = bev.pad_divisor
        self.img_hw = tuple(-(-s // pad) * pad for s in cfg.input_size)
        self.shapes = level_shapes(cfg.input_size, pad,
                                   1 + bev.out_indices[0], bev.num_levels)
        with torch.device(device):
            self.img_backbone = ResNet(bev.base_channels, bev.stage_blocks,
                                       bev.stage_with_dcn, bev.out_indices)
            self.img_neck = FPN(self.img_backbone.out_channels, c,
                                bev.num_levels)
            self.embeds = BEVEmbeddings(c, gy, gx, bev.num_levels,
                                        cfg.num_cams)
            self.can_bus_mlp = nn.Sequential(
                Linear(CAN_BUS, c // 2), nn.ReLU(),
                Linear(c // 2, c), nn.ReLU())
            self.can_bus_mlp.add_module('norm', LayerNorm(c, eps=1e-5))
            self.encoder = BEVEncoder(bev, (gy, gx), self.shapes)
            self.decoder = nn.Sequential(Linear(c, 2 * c), nn.Softplus(),
                                         Linear(2 * c, gz * bev.out_dim))
            self.predicter = nn.Sequential(
                Linear(bev.out_dim, 2 * bev.out_dim), nn.Softplus(),
                Linear(2 * bev.out_dim, cfg.num_classes))
            ry, rx = torch.meshgrid(torch.linspace(0.5, gy - 0.5, gy) / gy,
                                    torch.linspace(0.5, gx - 0.5, gx) / gx,
                                    indexing='ij')
            self.register_buffer('ref_2d', torch.stack(
                [rx.reshape(-1), ry.reshape(-1)], -1), persistent=False)
            self.register_buffer('pillars', pillar_points(
                cfg, bev.pillar_points), persistent=False)
        self.eval()

    eval_semantics = OccModel.eval_semantics

    @property
    def input_frames(self) -> int:
        return 1

    def init_streaming_state(self, batch_size: int = 1) -> BEVState:
        """An empty state on the model's device."""
        dev = next(self.parameters()).device
        return BEVState(
            torch.zeros(batch_size, self.bev_h * self.bev_w,
                        self.bev.embed_dims, dtype=self.cfg.dtype,
                        device=dev),
            torch.eye(4, device=dev).expand(batch_size, 4, 4).clone(),
            torch.zeros(batch_size, dtype=torch.bool, device=dev))

    def rig_index(self, batch: Batch) -> RigIndex:
        """The re-batch index of the key frame's rig (batch element 0's;
        one rig serves the batch, as in BEVFormer)."""
        with profiling.span('bev.sca.rebatch'):
            l2i = lidar2img(batch.sensor2keyego[0, 0].float(),
                            batch.intrins[0, 0].float(),
                            batch.post_rots[0, 0].float(),
                            batch.post_trans[0, 0].float())
            uv, mask = project(self.pillars, l2i, self.img_hw)
            hit = mask.any(-1)                                  # (N, Q)
            N, Q = hit.shape
            seen = hit.sum(1)
            with profiling.wait('sca.rebatch'):
                lm = max(int(seen.max()), 1)
            order = torch.sort((~hit).to(torch.uint8), dim=1,
                               stable=True).indices[:, :lm]
            keep = torch.arange(lm, device=hit.device)[None] < seen[:, None]
            D = uv.shape[2]
            ref = uv.gather(1, order[..., None, None].expand(N, lm, D, 2))
            return RigIndex(torch.where(keep, order, Q),
                            torch.where(keep[..., None, None], ref, 0.0),
                            hit.sum(0).clamp(min=1).float())

    def image_features(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) -> the encoder's values (B * N, S, C): the FPN
        levels flattened row-major, each with its level's and camera's
        embedding."""
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        x = F.pad(x, (0, self.img_hw[1] - W, 0, self.img_hw[0] - H))
        with profiling.span('camera.backbone'):
            feats = self.img_backbone(x.to(self.cfg.dtype))
        with profiling.span('camera.neck'):
            feats = self.img_neck(feats)
            e = self.embeds
            out = []
            for lvl, f in enumerate(feats):
                if tuple(f.shape[2:]) != self.shapes[lvl]:
                    raise ValueError(f'level {lvl} is {tuple(f.shape[2:])}, '
                                     f'not {self.shapes[lvl]}')
                f = f.flatten(2).transpose(1, 2).reshape(B, N, -1,
                                                         f.shape[1])
                out.append(f + e.cams_embeds.to(f.dtype)[None, :, None]
                           + e.level_embeds[lvl].to(f.dtype))
            return torch.cat(out, 2).view(B * N, -1, f.shape[-1])

    def bev_features(self, value: torch.Tensor, rig: RigIndex,
                     pose: torch.Tensor, state: BEVState,
                     valid: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, Q, C) for the frame at ``pose``, with
        the state's BEV where ``valid``."""
        dtype = self.cfg.dtype
        bus = can_bus(pose, state.ego2global.float(), valid,
                      self.bev.frame_interval_s)
        shift = bev_shift(bus, self.cfg.grid, self.bev_h, self.bev_w)
        with profiling.span('stream.rotate'):
            prev = rotate_bev(state.prev_bev, bus[:, 17], self.bev_h,
                              self.bev_w)
        e = self.embeds
        q0 = (e.bev_queries.to(dtype)[None]
              + self.can_bus_mlp(bus)[:, None].to(dtype))
        ref2d = self.ref_2d[None] + shift[:, None]
        with profiling.span('bev.encoder'):
            return self.encoder(q0, e.position().to(dtype), prev, valid,
                                ref2d, value, rig)

    def head(self, bev: torch.Tensor) -> torch.Tensor:
        """(B, Q, C) -> (B, X, Y, Z, classes) float32 logits."""
        B = bev.shape[0]
        with profiling.span('head'):
            x = self.decoder(bev).view(B, self.bev_h, self.bev_w,
                                       self.cfg.grid.size_z, -1)
            h = F.softplus(self.predicter[0](x))
            return self.predicter[2](h.float()).transpose(1, 2)

    @_inference
    def predict_streaming(self, batch: Batch, state: BEVState,
                          rig: Optional[RigIndex] = None,
                          reset: Optional[torch.Tensor] = None):
        """One frame (frame 0 of ``batch``) on the state the frame before
        left; where the state is not valid (a scene start, or ``reset``
        (B,) bool set) the frame has no history.  ``rig``: the key frame's
        ``rig_index``, else built in the call.  Returns (pred (B, X, Y, Z)
        uint8, {'occ_logits'}, the new state)."""
        if batch.ego2global is None:
            raise ValueError('streaming needs ego2global in the batch')
        valid = state.valid if reset is None else state.valid & ~reset
        if rig is None:
            rig = self.rig_index(batch)
        pose = batch.ego2global.float()
        bev = self.bev_features(self.image_features(batch.imgs[:, 0]), rig,
                                pose, state, valid)
        logits = self.head(bev)
        pred = logits.argmax(dim=-1).to(torch.uint8)
        return pred, {'occ_logits': logits}, BEVState(
            bev, pose, torch.ones_like(valid))

    @_inference
    def predict(self, batch: Batch, rig: Optional[RigIndex] = None
                ) -> torch.Tensor:
        """One frame with no history: (B, X, Y, Z) uint8 class ids."""
        B = batch.imgs.shape[0]
        state = self.init_streaming_state(B)
        if batch.ego2global is None:
            batch = batch._replace(ego2global=state.ego2global)
        return self.predict_streaming(batch, state, rig)[0]
