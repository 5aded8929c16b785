"""BEVFormer-Occ, plain PyTorch: the reference the stream_temporal cell
holds the port to.

Occ3D's baseline (Tian et al., arXiv:2304.14365; the challenge
repository's ``projects/configs/bevformer/bevformer_base_occ.py``) on
BEVFormer's layers (Li et al., arXiv:2203.17270; ``fundamentalvision/
BEVFormer``'s ``transformer.py``, ``encoder.py``,
``temporal_self_attention.py`` and ``spatial_cross_attention.py``) and
Deformable DETR's multi-scale deformable attention (arXiv:2010.04159),
written from those equations on the frozen reference layers, with the
port's module names so one state dict loads into both.  Float32 with TF32
off unless the caller asks for the configuration's precision; nothing of
the port or of the JAX package is imported.

A frame: the six images, padded at the bottom and right to a multiple of
32 (mmdet's ``PadMultiViewImage``), through a caffe-style ResNet with
DCNv2 (``DeformConv2d``: each tap's bilinear sample written out, zeros
outside the map, times its sigmoid mask, then one product) and frozen
BatchNorm, and mmdet's FPN with one extra stride-2 conv on its last output
(``relu_before_extra_convs`` acts on no level here); the levels flattened
with camera and level embeddings; the BEV queries plus the can-bus MLP's
embedding; six layers of temporal self-attention, LayerNorm, spatial
cross-attention, LayerNorm, FFN, LayerNorm (post-norm, eps 1e-5); the
occupancy head.  The sampling of both attentions is ``msda``: per level,
the bilinear taps of ``align_corners=False`` written out (zeros outside)
and summed with the attention weights, through ``counting.kernel_call``
with the frozen count 10·Q·H·L·P·d (``msda_flops``).

Spatial cross-attention runs densely: every camera's attention over all
the BEV queries, each camera's output kept where one of the query's 4
pillar anchors projects into its image (in front, inside (0, 1) of the
padded image), summed over the cameras and divided by the number of
cameras that see the query (at least 1).  The port re-batches the seen
queries per camera; this checks that against the plain sum.

The stream (``frame``): the test-time can-bus rule of BEVFormer's
``forward_test``: at a scene start there is no previous BEV, the
translation and yaw deltas are 0 and temporal self-attention's values are
[query, query] of the layer; otherwise the previous BEV, rotated by the
yaw change (degrees) about the map's centre with nearest sampling and
zeros outside (torchvision's ``rotate``, written out), and the encoder's
input queries are its values in every layer, with the reference points of
both shifted by the translation (BEVFormer's aliased ``shift_ref_2d``).

Departures from the published code, each of form or of an input it does
not define:
- the ego frame stands for the LiDAR frame (``lidar2img`` from the rig's
  camera-to-ego pose, the intrinsics and the 2D image augmentation);
- images arrive as floats and are not normalised inside;
- can-bus entries: the translation since the last frame (global), the
  ego rotation as a yaw quaternion (w, 0, 0, z), zero acceleration and
  rotation rate, the ego-frame velocity as that translation over the
  frame interval, the yaw (radians, [0, 2 pi)) and its change (degrees);
  the vector and its MLP in float32;
- the occupancy head as recalled (the challenge repository's file is not
  at hand): Linear C -> 2C, Softplus, Linear 2C -> Z·out per BEV cell,
  then the predicter out -> 2·out -> classes; the logits returned as
  (B, X, Y, Z, classes);
- inference only, batch elements each with their own previous BEV
  (BEVFormer's temporal attention takes ``value[:bs]``, which is that at
  batch 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import ModelConfig
from .counting import kernel_call
from .layers import BatchNorm, Conv2d, LayerNorm, Linear, _fp8


@dataclass(frozen=True)
class BEVFormerConfig:
    """A frozen copy of the port's ``BEVFormerConfig``, field for field."""
    base_channels: int = 64
    stage_blocks: Tuple[int, ...] = (3, 4, 23, 3)
    stage_with_dcn: Tuple[bool, ...] = (False, False, True, True)
    out_indices: Tuple[int, ...] = (1, 2, 3)
    num_levels: int = 4
    pad_divisor: int = 32
    embed_dims: int = 256
    num_heads: int = 8
    num_layers: int = 6
    ffn_dims: int = 512
    tsa_points: int = 4
    sca_points: int = 8
    pillar_points: int = 4
    out_dim: int = 32
    frame_interval_s: float = 0.5


def msda_flops(Q: int, H: int, L: int, P: int, d: int) -> int:
    """The frozen count of one sampling: per query, head, level, point and
    channel, 4 taps (4 multiplies, 3 adds), the weight's multiply and the
    sum's add, rounded up to 10."""
    return 10 * Q * H * L * P * d


def bilinear(value: torch.Tensor, h: int, w: int, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """value (M, h*w, E) row-major; x, y (M, K) pixel coordinates (pixel
    centres at integers) -> (M, K, E), zeros outside the map."""
    x0, y0 = torch.floor(x), torch.floor(y)
    out = 0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wt = (1 - (x - xi).abs()) * (1 - (y - yi).abs())
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            g = torch.gather(value, 1, idx[..., None].expand(
                -1, -1, value.shape[-1]))
            out = out + g * (wt * ok)[..., None]
    return out


def _msda(value, shapes, loc, weights):
    """value (M, S, H, d); loc (M, Q, H, L, P, 2) in [0, 1]; weights (M,
    Q, H, L, P) -> (M, Q, H*d) float32."""
    M, S, H, d = value.shape
    _, Q, _, L, P, _ = loc.shape
    out = torch.zeros(M, Q, H, d, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].float()
        start += h * w
        v = v.permute(0, 2, 1, 3).reshape(M * H, h * w, d)
        xy = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(M * H, Q * P, 2)
        s = bilinear(v, h, w, xy[..., 0] * w - 0.5, xy[..., 1] * h - 0.5)
        s = s.view(M, H, Q, P, d)
        wt = weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        out = out + (s * wt[..., None]).sum(3).permute(0, 2, 1, 3)
    return out.reshape(M, Q, H * d)


def msda(value, shapes, loc, weights, needed=None):
    """``_msda`` counted as ``msda_flops`` of its M x Q queries, or of
    ``needed()`` queries (the work the sampling needs) when given."""
    M, _, H, d = value.shape
    _, Q, _, L, P, _ = loc.shape
    return kernel_call(
        lambda v, lc, wt: _msda(v, shapes, lc, wt),
        lambda: msda_flops(needed() if needed else M * Q, H, L, P, d),
        value, loc, weights)


class DeformConv2d(Conv2d):
    """DCNv2, one deformable group, no bias: ``conv_offset`` gives the 9
    taps' (dy, dx) at channels (2k, 2k + 1) and their mask logits."""

    def __init__(self, c: int, cout: int):
        super().__init__(c, cout, 3, 1, 1, bias=False)
        self.conv_offset = Conv2d(c, 27, 3, 1, 1, bias=True)

    def forward(self, x):
        B, C, H, W = x.shape
        o = self.conv_offset(x).float()
        off, mask = o[:, :18], torch.sigmoid(o[:, 18:])
        ki = torch.arange(3, device=x.device).repeat_interleave(3)
        kj = torch.arange(3, device=x.device).repeat(3)
        ys = (torch.arange(H, device=x.device).view(1, 1, H, 1) - 1
              + ki.view(1, 9, 1, 1) + off[:, 0::2])
        xs = (torch.arange(W, device=x.device).view(1, 1, 1, W) - 1
              + kj.view(1, 9, 1, 1) + off[:, 1::2])
        flat = x.float().flatten(2).transpose(1, 2)          # (B, HW, C)
        taps = bilinear(flat, H, W, xs.reshape(B, -1), ys.reshape(B, -1))
        taps = taps.view(B, 9, H * W, C) * mask.reshape(B, 9, H * W, 1)
        cols = taps.permute(0, 3, 1, 2).reshape(B, C * 9, H * W).to(x.dtype)
        w = _fp8(self.weight.to(x.dtype)).reshape(self.out_channels, C * 9)
        return (w @ _fp8(cols)).view(B, -1, H, W)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dcn, downsample):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, stride, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = (DeformConv2d(planes, planes) if dcn
                      else Conv2d(planes, planes, 3, 1, 1, bias=False))
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride, bias=False),
            BatchNorm(planes * 4)) if downsample else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + idt)


class ResNet(nn.Module):
    def __init__(self, bev: BEVFormerConfig):
        super().__init__()
        base = bev.base_channels
        self.out_indices = bev.out_indices
        self.conv1 = Conv2d(3, base, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(base)
        cin = base
        self.stages = len(bev.stage_blocks)
        for i, n in enumerate(bev.stage_blocks):
            planes = base * 2 ** i
            stride = 1 if i == 0 else 2
            layer = [Bottleneck(cin, planes, stride, bev.stage_with_dcn[i],
                                True)]
            layer += [Bottleneck(planes * 4, planes, 1,
                                 bev.stage_with_dcn[i], False)
                      for _ in range(n - 1)]
            self.add_module(f'layer{i + 1}', nn.Sequential(*layer))
            cin = planes * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for i in range(self.stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return outs


class _ConvModule(nn.Module):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, k // 2, bias=True)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, cins: List[int], c: int, outs: int):
        super().__init__()
        self.lateral_convs = nn.ModuleList(_ConvModule(i, c, 1) for i in cins)
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(c, c, 3) for _ in cins]
            + [_ConvModule(c, c, 3, 2) for _ in range(outs - len(cins))])

    def forward(self, xs):
        lat = [m(x) for m, x in zip(self.lateral_convs, xs)]
        for i in reversed(range(1, len(lat))):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[-2:], mode='nearest')
        outs = [self.fpn_convs[i](lat[i]) for i in range(len(lat))]
        outs.append(self.fpn_convs[len(lat)](outs[-1]))   # 'on_output'
        for i in range(len(lat) + 1, len(self.fpn_convs)):
            outs.append(self.fpn_convs[i](F.relu(outs[-1])))
        return outs


class BEVEmbeddings(nn.Module):
    def __init__(self, c, bev_h, bev_w, levels, cams):
        super().__init__()
        self.bev_queries = nn.Parameter(torch.zeros(bev_h * bev_w, c))
        self.row_embed = nn.Parameter(torch.zeros(bev_h, c // 2))
        self.col_embed = nn.Parameter(torch.zeros(bev_w, c // 2))
        self.level_embeds = nn.Parameter(torch.zeros(levels, c))
        self.cams_embeds = nn.Parameter(torch.zeros(cams, c))


class TSA(nn.Module):
    def __init__(self, c, heads, points):
        super().__init__()
        self.sampling_offsets = Linear(2 * c, 2 * heads * points * 2)
        self.attention_weights = Linear(2 * c, 2 * heads * points)
        self.value_proj = Linear(c, c)
        self.output_proj = Linear(c, c)


class MSDA3D(nn.Module):
    def __init__(self, c, heads, levels, points):
        super().__init__()
        self.sampling_offsets = Linear(c, heads * levels * points * 2)
        self.attention_weights = Linear(c, heads * levels * points)
        self.value_proj = Linear(c, c)


class SCA(nn.Module):
    def __init__(self, c, heads, levels, points):
        super().__init__()
        self.deformable_attention = MSDA3D(c, heads, levels, points)
        self.output_proj = Linear(c, c)


class Layer(nn.Module):
    def __init__(self, bev: BEVFormerConfig):
        super().__init__()
        c = bev.embed_dims
        self.attentions = nn.ModuleList([
            TSA(c, bev.num_heads, bev.tsa_points),
            SCA(c, bev.num_heads, bev.num_levels, bev.sca_points)])
        self.norms = nn.ModuleList(LayerNorm(c, eps=1e-5) for _ in range(3))
        ffn = nn.Module()
        ffn.layers = nn.Sequential(nn.Sequential(Linear(c, bev.ffn_dims),
                                                 nn.ReLU()),
                                   Linear(bev.ffn_dims, c))
        self.ffns = nn.ModuleList([ffn])


class Encoder(nn.Module):
    def __init__(self, bev: BEVFormerConfig):
        super().__init__()
        self.layers = nn.ModuleList(Layer(bev) for _ in range(bev.num_layers))


def reference_points(cfg: ModelConfig, bev: BEVFormerConfig, device):
    """(D, H*W, 3) normalised pillar anchors and (H*W, 2) BEV points
    (BEVFormer's ``get_reference_points``, 3D and 2D)."""
    H, W, D = cfg.grid.size_y, cfg.grid.size_x, bev.pillar_points
    Zr = cfg.grid.z[1] - cfg.grid.z[0]
    zs = (torch.linspace(0.5, Zr - 0.5, D, device=device)
          .view(-1, 1, 1).expand(D, H, W) / Zr)
    xs = (torch.linspace(0.5, W - 0.5, W, device=device)
          .view(1, 1, W).expand(D, H, W) / W)
    ys = (torch.linspace(0.5, H - 0.5, H, device=device)
          .view(1, H, 1).expand(D, H, W) / H)
    ref_3d = torch.stack((xs, ys, zs), -1).flatten(1, 2)
    ry, rx = torch.meshgrid(
        torch.linspace(0.5, H - 0.5, H, device=device),
        torch.linspace(0.5, W - 0.5, W, device=device), indexing='ij')
    return ref_3d, torch.stack((rx.reshape(-1) / W, ry.reshape(-1) / H), -1)


def padded_hw(cfg: ModelConfig, bev: BEVFormerConfig):
    p = bev.pad_divisor
    return [int(math.ceil(s / p) * p) for s in cfg.input_size]


def point_sampling(cfg: ModelConfig, bev: BEVFormerConfig, s2e, intrins,
                   post_rots, post_trans):
    """BEVFormer's ``point_sampling`` for cameras at ``s2e`` (B, N, 4, 4)
    with their intrinsics and 2D augmentation: (B, N, Q, D, 2) image
    coordinates over the padded image and the (B, N, Q, D) mask of the
    anchors in front of a camera and inside its image."""
    g = cfg.grid
    ref_3d, _ = reference_points(cfg, bev, s2e.device)
    lo = torch.tensor([g.x[0], g.y[0], g.z[0]], device=ref_3d.device)
    hi = torch.tensor([g.x[1], g.y[1], g.z[1]], device=ref_3d.device)
    p = ref_3d * (hi - lo) + lo
    p = torch.cat([p, torch.ones_like(p[..., :1])], -1)       # (D, Q, 4)
    s2e = s2e.float()
    B, N = s2e.shape[:2]
    view = torch.eye(4, device=s2e.device).repeat(B, N, 1, 1)
    view[..., :3, :3] = intrins
    aug = torch.eye(4, device=s2e.device).repeat(B, N, 1, 1)
    aug[..., :2, :2] = post_rots[..., :2, :2]
    aug[..., :2, 2] = post_trans[..., :2]
    l2i = aug @ view @ torch.linalg.inv(s2e)
    cam = torch.einsum('bnij,dqj->bnqdi', l2i, p)
    eps = 1e-5
    mask = cam[..., 2] > eps
    xy = cam[..., :2] / torch.maximum(cam[..., 2:3],
                                      torch.ones_like(cam[..., 2:3]) * eps)
    ph, pw = padded_hw(cfg, bev)
    xy = torch.stack([xy[..., 0] / pw, xy[..., 1] / ph], -1)
    mask = (mask & (xy[..., 1] > 0) & (xy[..., 1] < 1)
            & (xy[..., 0] < 1) & (xy[..., 0] > 0))
    return xy, mask


def yaw_degrees(pose: torch.Tensor) -> torch.Tensor:
    """The ego yaw of (B, 4, 4) poses in degrees, in [0, 360)."""
    yaw = torch.atan2(pose[:, 1, 0], pose[:, 0, 0]) / math.pi * 180
    return yaw + 360 * (yaw < 0)


class BEVFormerOcc(nn.Module):
    """BEVFormer-Occ; ``frame(batch, prev)`` runs one frame."""

    def __init__(self, cfg: ModelConfig, bev: BEVFormerConfig = None,
                 device='cuda'):
        super().__init__()
        bev = bev or BEVFormerConfig()
        self.cfg, self.bev = cfg, bev
        self.W, self.H, self.Z = cfg.grid.size_x, cfg.grid.size_y, \
            cfg.grid.size_z
        c = bev.embed_dims
        with torch.device(device):
            self.img_backbone = ResNet(bev)
            self.img_neck = FPN([bev.base_channels * 4 * 2 ** i
                                 for i in bev.out_indices], c, bev.num_levels)
            self.embeds = BEVEmbeddings(c, self.H, self.W, bev.num_levels,
                                        cfg.num_cams)
            self.can_bus_mlp = nn.Sequential(
                Linear(18, c // 2), nn.ReLU(),
                Linear(c // 2, c), nn.ReLU())
            self.can_bus_mlp.add_module('norm', LayerNorm(c, eps=1e-5))
            self.encoder = Encoder(bev)
            self.decoder = nn.Sequential(Linear(c, 2 * c), nn.Softplus(),
                                         Linear(2 * c, self.Z * bev.out_dim))
            self.predicter = nn.Sequential(
                Linear(bev.out_dim, 2 * bev.out_dim), nn.Softplus(),
                Linear(2 * bev.out_dim, cfg.num_classes))
        self.eval()

    def point_sampling(self, batch):
        """``point_sampling`` of the batch's key frame."""
        return point_sampling(self.cfg, self.bev, batch.sensor2keyego[:, 0],
                              batch.intrins[:, 0], batch.post_rots[:, 0],
                              batch.post_trans[:, 0])

    def can_bus(self, pose, prev_pose):
        """(B, 18) float32; ``prev_pose`` None at a scene start."""
        B = pose.shape[0]
        out = torch.zeros(B, 18, device=pose.device)
        deg = yaw_degrees(pose)
        if prev_pose is not None:
            out[:, :3] = pose[:, :3, 3] - prev_pose[:, :3, 3]
            out[:, 13:16] = (torch.einsum('bji,bj->bi', pose[:, :3, :3],
                                          out[:, :3])
                             / self.bev.frame_interval_s)
            out[:, 17] = deg - yaw_degrees(prev_pose)
        yaw = torch.atan2(pose[:, 1, 0], pose[:, 0, 0])
        out[:, 3] = torch.cos(yaw / 2)
        out[:, 6] = torch.sin(yaw / 2)
        out[:, 16] = deg / 180 * math.pi
        return out

    def rotate(self, bev, angle):
        """(B, Q, C) BEV images rotated by ``angle`` (B,) degrees about the
        centre, nearest, zeros outside (torchvision's ``rotate``)."""
        B, Q, C = bev.shape
        H, W = self.H, self.W
        out = torch.zeros_like(bev)
        x = torch.arange(W, device=bev.device) - W / 2 + 0.5
        y = torch.arange(H, device=bev.device) - H / 2 + 0.5
        yy, xx = torch.meshgrid(y, x, indexing='ij')
        for b in range(B):
            a = float(angle[b]) / 180 * math.pi
            sx = math.cos(a) * xx - math.sin(a) * yy + W / 2 - 0.5
            sy = math.sin(a) * xx + math.cos(a) * yy + H / 2 - 0.5
            ix, iy = torch.round(sx).long(), torch.round(sy).long()
            ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            src = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(-1)
            out[b] = bev[b, src] * ok.reshape(-1, 1)
        return out

    # -- the layers ---------------------------------------------------------
    def features(self, imgs):
        """(B, N, H, W, 3) -> the levels' values (B, N, S, C) and shapes."""
        B, N, H, W, _ = imgs.shape
        ph, pw = padded_hw(self.cfg, self.bev)
        x = torch.zeros(B * N, 3, ph, pw, device=imgs.device,
                        dtype=self.cfg.dtype)
        x[:, :, :H, :W] = imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        feats = self.img_neck(self.img_backbone(x))
        e = self.embeds
        vals, shapes = [], []
        for lvl, f in enumerate(feats):
            shapes.append(tuple(f.shape[-2:]))
            f = f.reshape(B, N, f.shape[1], -1).transpose(2, 3)
            vals.append(f + e.cams_embeds[None, :, None].to(f.dtype)
                        + e.level_embeds[None, None, lvl:lvl + 1].to(f.dtype))
        return torch.cat(vals, 2), shapes

    def tsa(self, m, query, pos, value2, ref2d):
        """value2 (B, 2, Q, C): [previous, current] values."""
        B, Q, C = query.shape
        Hh, P = self.bev.num_heads, self.bev.tsa_points
        q = torch.cat([value2[:, 0], query + pos], -1)
        v = m.value_proj(value2.reshape(B * 2, Q, C)).view(B * 2, Q, Hh, -1)
        off = m.sampling_offsets(q).view(B, Q, Hh, 2, 1, P, 2).float()
        wts = m.attention_weights(q).view(B, Q, Hh, 2, P).float()
        wts = torch.softmax(wts, -1)
        norm = torch.tensor([self.W, self.H], device=off.device).float()
        loc = ref2d[:, :, None, None, None, None, :] + off / norm
        loc = loc.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * 2, Q, Hh, 1, P, 2)
        wts = wts.permute(0, 3, 1, 2, 4).reshape(B * 2, Q, Hh, 1, P)
        out = msda(v, [(self.H, self.W)], loc, wts).view(B, 2, Q, C)
        out = ((out[:, 0] + out[:, 1]) / 2).to(query.dtype)
        return m.output_proj(out) + query

    def sca(self, m, query, value, shapes, xy, mask):
        """query (B, Q, C); value (B, N, S, C); xy (B, N, Q, D, 2), mask
        (B, N, Q, D): every camera over every query, kept where seen."""
        B, Q, C = query.shape
        N = value.shape[1]
        Hh, L = self.bev.num_heads, self.bev.num_levels
        P, D = self.bev.sca_points, self.bev.pillar_points
        a = m.deformable_attention
        v = a.value_proj(value).view(B, N, value.shape[2], Hh, -1)
        off = a.sampling_offsets(query).view(B, Q, Hh, L, P // D, D, 2)
        norm = torch.tensor([[w, h] for h, w in shapes],
                            device=off.device).float()
        off = off.float() / norm[:, None, None, :]
        wts = a.attention_weights(query).view(B, Q, Hh, L * P).float()
        wts = torch.softmax(wts, -1).view(B, Q, Hh, L, P)
        seen = mask.any(-1)                                   # (B, N, Q)
        slots = torch.zeros(B, Q, C, device=query.device)
        for n in range(N):
            loc = (xy[:, n][:, :, None, None, None] + off).reshape(
                B, Q, Hh, L, P, 2)
            out = msda(v[:, n], shapes, loc, wts,
                       lambda n=n: int(seen[:, n].sum()))
            slots = slots + out * seen[:, n, :, None]
        count = seen.sum(1).clamp(min=1)
        slots = (slots / count[..., None]).to(query.dtype)
        return m.output_proj(slots) + query

    def frame(self, batch, prev=None):
        """One frame: (logits (B, X, Y, Z, classes) float32, the BEV (B, Q,
        C)); ``prev``: None at a scene start, else (previous BEV, its ego
        pose)."""
        dt = self.cfg.dtype
        pose = batch.ego2global.float()
        bus = self.can_bus(pose, None if prev is None else prev[1])
        value, shapes = self.features(batch.imgs[:, 0])
        xy, mask = self.point_sampling(batch)
        e = self.embeds
        H, W = self.H, self.W
        q0 = (e.bev_queries[None].to(dt)
              + self.can_bus_mlp(bus)[:, None].to(dt))
        pos = torch.cat([e.col_embed[None].expand(H, W, -1),
                         e.row_embed[:, None].expand(H, W, -1)], -1)
        pos = pos.reshape(H * W, -1)[None].to(dt)
        # BEVFormer's shift from the can bus, in BEV units
        dx, dy = bus[:, 0], bus[:, 1]
        length = torch.sqrt(dx ** 2 + dy ** 2)
        bev_angle = bus[:, 16] / math.pi * 180 - torch.atan2(dy, dx) / \
            math.pi * 180
        g = self.cfg.grid
        shift_y = (length * torch.cos(bev_angle / 180 * math.pi)
                   / ((g.y[1] - g.y[0]) / H) / H)
        shift_x = (length * torch.sin(bev_angle / 180 * math.pi)
                   / ((g.x[1] - g.x[0]) / W) / W)
        _, ref2d = reference_points(self.cfg, self.bev, pose.device)
        ref2d = ref2d[None] + torch.stack([shift_x, shift_y], -1)[:, None]
        prev_bev = None if prev is None else self.rotate(prev[0], bus[:, 17])
        q = q0
        for layer in self.encoder.layers:
            value2 = (torch.stack([q, q], 1) if prev_bev is None
                      else torch.stack([prev_bev.to(dt), q0], 1))
            q = layer.norms[0](self.tsa(layer.attentions[0], q, pos, value2,
                                        ref2d))
            q = layer.norms[1](self.sca(layer.attentions[1], q, value,
                                        shapes, xy, mask))
            q = layer.norms[2](q + layer.ffns[0].layers(q))
        x = self.decoder(q).view(q.shape[0], H, W, self.Z, -1)
        h = F.softplus(self.predicter[0](x))
        logits = self.predicter[2](h.float())
        return logits.permute(0, 2, 1, 3, 4), q
