"""Typed configuration for the PyTorch port of FusionOcc.

A field-for-field mirror of ``fusionocc_tpu/config.py`` that imports no JAX:
the same frozen dataclasses, defaults and presets, so a configuration built
here equals the reference package's field by field.  Derived sizes are
properties; ``GridConfig.lower_bound`` / ``interval`` return plain tuples and
``ModelConfig.dtype`` a ``torch.dtype``.

Fields that only the JAX package acts on (the TPU tiling knobs and
formulation switches) are kept so that configurations compare equal.
``OptimConfig``, ``EvalConfig`` and ``TrainConfig`` mirror the training
configuration the same way; the named presets are in ``configs.py``.
``check_supported`` and ``check_train_supported`` reject the values that
would select a path the port does not have.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import torch


@dataclass(frozen=True)
class GridConfig:
    """BEV/voxel grid bounds (x, y, z: lo, hi, step; depth bins likewise)."""
    x: Tuple[float, float, float] = (-40.0, 40.0, 0.4)
    y: Tuple[float, float, float] = (-40.0, 40.0, 0.4)
    z: Tuple[float, float, float] = (-1.0, 5.4, 0.4)
    depth: Tuple[float, float, float] = (1.0, 45.0, 0.5)

    @property
    def size_x(self) -> int:
        return int(round((self.x[1] - self.x[0]) / self.x[2]))

    @property
    def size_y(self) -> int:
        return int(round((self.y[1] - self.y[0]) / self.y[2]))

    @property
    def size_z(self) -> int:
        return int(round((self.z[1] - self.z[0]) / self.z[2]))

    @property
    def num_depth_bins(self) -> int:
        lo, hi, step = self.depth
        return int(round((hi - lo) / step))

    @property
    def lower_bound(self) -> Tuple[float, float, float]:
        return (self.x[0], self.y[0], self.z[0])

    @property
    def interval(self) -> Tuple[float, float, float]:
        return (self.x[2], self.y[2], self.z[2])

    @property
    def grid_size(self):
        return (self.size_x, self.size_y, self.size_z)

    @property
    def point_cloud_range(self) -> Tuple[float, ...]:
        return (self.x[0], self.y[0], self.z[0], self.x[1], self.y[1], self.z[1])


@dataclass(frozen=True)
class SwinConfig:
    """Swin backbone (Swin-Base by default).

    The port runs every stage through the window-attention op
    (``ops/window_attn.py``) whatever ``fused_attn`` says: the JAX package's
    unfused path differs from it only in storing scores in the compute dtype.
    ``drop_path_rate`` and ``with_cp`` act in training only: each block
    draws its stochastic-depth masks from ``linspace(0, drop_path_rate,
    24)`` (JAX's rates), and ``with_cp`` runs each block under
    ``torch.utils.checkpoint`` with those masks drawn before it, so the
    recompute sees the same masks.  ``int8_dense`` serves the backbone's
    Linears through int8 products (``quant.int8_linear``), as JAX's
    ``int8_dot_general`` does.
    """
    embed_dims: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: int = 4
    out_indices: Tuple[int, ...] = (2, 3)
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    return_stereo_feat: bool = True
    with_cp: bool = True
    fused_attn: bool = True
    fused_attn_max_heads: int = 32
    int8_dense: bool = False

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(self.embed_dims * 2 ** i for i in range(len(self.depths)))


@dataclass(frozen=True)
class SparseEncoderConfig:
    """LiDAR sparse encoder.

    The port runs ``backend='zfold'``: voxelization with
    ``voxel_capacity[0]``, super rows of ``zfold`` cells cut at
    ``zfold_capacity``, sparse stages before ``dense_from`` and the masked
    dense tail after.  ``zconv`` 'zwin' and 'zband' compute the same
    contract and both run the zwin kernel.  Like them, the values of these
    switches give one result and take one path: ``dense_mode`` 'zbatch' and
    'xla3d' (two TPU formulations of one dense conv) and ``dense_from`` 3
    and 4 (the last stage has no stride-2 conv, so it runs in the dense tail
    either way).  ``zwin_fuse`` is honoured: the z-folded convs then run
    with the BatchNorm, ReLU and lane mask fused into the kernel's epilogue
    (``ops/zwin_conv.zwin_conv_epi``), as JAX's eval path does; the default
    stays False, the config's default (the JAX modules' own default is
    True).  The TPU tiling knobs ``zwin_block``, ``zwin_nwin``,
    ``zwin_bad_frac``, ``zwin_merged``, ``tap_chunk`` and ``col_chunk``
    change nothing in the result and are ignored, as are the other
    backends' fields (``gather``, ``index``, ``tile_*``,
    ``voxel_capacity[1:]``).  The training switch ``remat_conv`` is taken
    and changes nothing: in JAX it checkpoints each conv so that its
    backward recomputes the gather, and in the port every conv it covers
    (the zwin ``Function``, the dense tail's cuDNN conv) already saves its
    inputs only and recomputes the rest in its backward.
    """
    in_channels: int = 5
    base_channels: int = 16
    encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 48), (48, 48, 64), (64, 64))
    output_channels: int = 32
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    point_capacity: int = 2 ** 17
    voxel_capacity: Tuple[int, ...] = (2 ** 17, 196608, 98304, 49152)
    backend: str = 'zfold'
    gather: str = 'row'
    index: str = 'table'
    tile_size: int = 8
    tile_capacity: Tuple[int, ...] = (2 ** 14, 2 ** 13, 2 ** 12, 1250)
    zfold: int = 8
    zfold_capacity: Tuple[int, ...] = (81920, 86016, 73728, 32768)
    tap_chunk: int = 9
    zconv: str = 'zwin'
    zwin_block: int = 128
    zwin_nwin: int = 6
    zwin_bad_frac: float = 0.03125
    zwin_merged: bool = False
    zwin_fuse: bool = False
    col_chunk: int = 3
    dense_from: int = 3
    dense_mode: str = 'zbatch'
    stop_after: str = ''
    profile_no_bn: bool = False
    remat_conv: bool = True

    def sparse_shape(self, grid: GridConfig) -> Tuple[int, int, int]:
        pcr = grid.point_cloud_range
        return (
            int(round((pcr[3] - pcr[0]) / self.voxel_size[0])),
            int(round((pcr[4] - pcr[1]) / self.voxel_size[1])),
            int(round((pcr[5] - pcr[2]) / self.voxel_size[2])),
        )


@dataclass(frozen=True)
class ViewTransformerConfig:
    """CrossModalLSS."""
    in_channels: int = 256
    mid_channels: int = 128
    feature_channels: int = 32
    seg_num_classes: int = 18
    downsample: int = 16
    aspp_mid_channels: int = 96
    depth_drop_rate: float = 0.5
    sid: bool = False
    collapse_z: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Full FusionOcc model.  ``remat_bev`` checkpoints the BEV trunk
    (backbone and neck) in training, as JAX's ``nn.remat`` does."""
    num_cams: int = 6
    num_adj: int = 1
    input_size: Tuple[int, int] = (512, 1408)
    num_classes: int = 18
    grid: GridConfig = field(default_factory=GridConfig)
    swin: SwinConfig = field(default_factory=SwinConfig)
    lidar: SparseEncoderConfig = field(default_factory=SparseEncoderConfig)
    vt: ViewTransformerConfig = field(default_factory=ViewTransformerConfig)
    img_neck_out_channels: int = 256
    img_channels: int = 32
    lidar_out_channels: int = 32
    bev_num_layer: Tuple[int, ...] = (1, 2, 3)
    bev_strides: Tuple[int, ...] = (1, 2, 2)
    use_mask: bool = True
    use_lidar: bool = True
    mask_mode: str = 'baseline_with_mask'
    mask_dist_threshold_c: float = 35.0
    temperature: float = 1.0
    use_predicter: bool = True
    fuse_loss_weight: float = 0.1
    depth_loss_weight: float = 1.0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_bev: bool = False

    @property
    def num_frame(self) -> int:
        return self.num_adj + 1

    @property
    def feat_size(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.vt.downsample,
                self.input_size[1] // self.vt.downsample)

    @property
    def fusion_channels(self) -> int:
        """Channels entering the BEV encoder: image frames + lidar."""
        return self.img_channels * self.num_frame + self.lidar_out_channels

    @property
    def occ_channels(self) -> int:
        return self.img_channels + self.lidar_out_channels

    @property
    def bev_channels(self) -> Tuple[int, ...]:
        c = self.occ_channels
        return (c, c * 2, c * 4)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclass(frozen=True)
class BEVFormerConfig:
    """BEVFormer-Occ's own sizes (``models/bevformer_occ.py``), with the
    published defaults of Occ3D's ``bevformer_base_occ.py``; the camera
    count, input size, classes, grid and compute dtype are the
    ``ModelConfig``'s.  The BEV is the grid's x-y plane (200 x 200) and the
    head's pillar its z cells (16).

    Backbone: a caffe-style ResNet of ``stage_blocks`` Bottlenecks (101:
    3, 4, 23, 3) at ``base_channels``, frozen BatchNorm, DCNv2 in place of
    the 3x3 conv of every block of the stages ``stage_with_dcn`` marks,
    outputs of the stages ``out_indices``; the mmdet FPN to ``embed_dims``
    with one extra stride-2 conv on its last output (``num_levels`` in
    all).  Images are padded to a multiple of ``pad_divisor``.  Encoder:
    ``num_layers`` layers of temporal self-attention (``tsa_points`` a head
    over two BEV frames), spatial cross-attention (``sca_points`` a head
    and level over ``pillar_points`` anchors a pillar) and an FFN of
    ``ffn_dims``.  ``frame_interval_s``: the key frames' interval, for the
    can-bus velocity."""
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


def tiny_bevformer_config(**overrides) -> BEVFormerConfig:
    """BEVFormer's block kinds at a CPU-testable size: one Bottleneck a
    stage but two in the third, DCN in the last two stages, two encoder
    layers of width 32 with 4 heads."""
    cfg = BEVFormerConfig(base_channels=8, stage_blocks=(1, 1, 2, 1),
                          embed_dims=32, num_heads=4, num_layers=2,
                          ffn_dims=64, out_dim=8)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclass(frozen=True)
class OptimConfig:
    """AdamW with warmup and cosine decay, clipping, EMA and accumulation
    (``train/loop.py``).  The same fields and defaults as JAX's."""
    lr: float = 5e-5
    weight_decay: float = 1e-2
    clip_norm: float = 5.0
    warmup_iters: int = 500
    warmup_start_factor: float = 1.0 / 3.0
    max_epochs: int = 24
    iters_per_epoch: int = 28130
    eta_min_factor: float = 1e-3
    ema_momentum: float = 0.001
    accumulate_steps: int = 1
    backbone_lr_mult: float = 1.0


@dataclass(frozen=True)
class EvalConfig:
    """The evaluation protocol: ``metric`` 'miou' (masked Occ3D mIoU),
    'rayiou' (RayIoU, evaluated without the camera mask) or 'hybrid' (both
    side by side); ``use_image_mask``; ``split`` of the infos file ('val',
    'val_eval' or 'val_calib', which ``tools/test_torch.py`` maps to
    ``fusionocc-nuscenes_infos_<split>.pkl`` next to ``--ann-file``)."""
    metric: str = 'miou'
    use_image_mask: bool = True
    split: str = 'val'


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    batch_size: int = 1
    seed: int = 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration that selects a path the
    port does not have yet, naming the ROADMAP item that brings it."""
    if cfg.use_lidar:
        lc = cfg.lidar
        unported = [(lc.backend != 'zfold', f'backend={lc.backend!r}'),
                    (lc.zconv not in ('zwin', 'zband'),
                     f'zconv={lc.zconv!r}'),
                    (lc.dense_from not in (3, 4),
                     f'dense_from={lc.dense_from}'),
                    (lc.dense_mode not in ('zbatch', 'xla3d'),
                     f'dense_mode={lc.dense_mode!r}'),
                    (bool(lc.stop_after) or lc.profile_no_bn,
                     'the profiling switches stop_after / profile_no_bn')]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(
                    f'lidar {what} is not ported: ROADMAP Queue A item 5 '
                    "ports the default path only (backend 'zfold', zconv "
                    "'zwin' or 'zband'); the COO, tile, lifted and zslice "
                    "paths are on ROADMAP's not-ported list")
    if cfg.param_dtype != 'float32':
        raise NotImplementedError(
            f'param_dtype={cfg.param_dtype!r}: the port keeps parameters in '
            'float32, as the JAX package does')


def check_train_supported(cfg: TrainConfig) -> None:
    """``check_supported`` on the model; every evaluation protocol
    (``EvalConfig.metric``) is ported."""
    check_supported(cfg.model)
    if cfg.eval.metric not in ('miou', 'rayiou', 'hybrid'):
        raise ValueError(f'eval.metric={cfg.eval.metric!r}: one of miou, '
                         'rayiou, hybrid')


def tiny_model_config(**overrides) -> ModelConfig:
    """A scaled-down config used by unit tests (CPU-friendly)."""
    grid = GridConfig(
        x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8), z=(-1.0, 2.2, 0.8),
        depth=(1.0, 9.0, 1.0))
    swin = SwinConfig(
        embed_dims=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
        window_size=4, drop_path_rate=0.0, with_cp=False, fused_attn=False)
    lidar = SparseEncoderConfig(
        in_channels=5, base_channels=4,
        encoder_channels=((4, 4, 8), (8, 8, 12), (12, 12, 16), (16, 16)),
        output_channels=8,
        voxel_size=(0.1, 0.1, 0.1),
        point_capacity=2048,
        voxel_capacity=(1024, 512, 256, 128),
        tile_capacity=(512, 256, 64, 16),
        zfold_capacity=(1024, 512, 256, 128),
        backend='coo', index='merge', remat_conv=False, tap_chunk=0)
    vt = ViewTransformerConfig(
        in_channels=32, mid_channels=16, feature_channels=8,
        seg_num_classes=18, downsample=16, aspp_mid_channels=8)
    cfg = ModelConfig(
        num_cams=2, num_adj=1, input_size=(64, 128),
        grid=grid, swin=swin, lidar=lidar, vt=vt,
        img_neck_out_channels=32, img_channels=8, lidar_out_channels=8,
        compute_dtype="float32")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def midsize_model_config(**overrides) -> ModelConfig:
    """Window-12 Swin on grids not divisible by 12, D=88 depth bins at
    downsample 16: the full-size structural edges at a CPU-testable size."""
    base = tiny_model_config()
    swin = dataclasses.replace(
        base.swin, embed_dims=32, depths=(1, 1, 2, 1),
        num_heads=(1, 2, 4, 8), window_size=12)
    lidar = dataclasses.replace(base.lidar, backend='zfold', zconv='zband')
    grid = dataclasses.replace(base.grid, depth=(1.0, 45.0, 0.5))
    cfg = dataclasses.replace(
        base, input_size=(176, 352), swin=swin, lidar=lidar, grid=grid)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def full_model_config(**overrides) -> ModelConfig:
    cfg = ModelConfig()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def image_only_model_config(**overrides) -> ModelConfig:
    """The ``fusion_occ_image_only`` preset: the full model with zero LiDAR
    features (the reference's image-only fallback)."""
    cfg = full_model_config(use_lidar=False)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
