"""Named configuration presets — the reference's config-variant zoo.

The reference ships ~26 python config files differing in leaf keys
(projects/FusionOcc/configs/: baseline, unified training recipe, mask
ablations, depth-supervision ablation, distance-condition masks, calibration
variants). Here each variant is a named preset over the frozen dataclasses.

The port's copy of ``fusionocc_tpu/configs.py``: the same names, the same
field values, on the port's ``TrainConfig``.

Two presets are other architectures on the same path:
``bevdet_occ_stbase_stereo``, BEVDet-Occ's BEVStereo4D-Occ with Swin-B at
512x1408 (``models/bevstereo_occ.py``), and ``bevformer_base_occ``,
Occ3D's BEVFormer-Occ with ResNet-101-DCN at 900x1600
(``models/bevformer_occ.py``, its own sizes ``config.BEVFormerConfig``'s
defaults).  ``build_model`` builds the model a preset names, of its class
(``ARCHITECTURES``; FusionOcc otherwise).

Usage:
    from fusionocc_tpu_torch.configs import get_config, CONFIGS
    cfg = get_config('fusion_occ_unified')
    model = build_model('bevdet_occ_stbase_stereo', device='cuda')
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple

from .config import (EvalConfig, ModelConfig, OptimConfig, TrainConfig,
                     ViewTransformerConfig, full_model_config,
                     tiny_model_config)


def _baseline() -> TrainConfig:
    """configs/fusion_occ.py: lr 5e-5, clip 5, 24 epochs, camera mask on."""
    return TrainConfig(model=full_model_config(), optim=OptimConfig())


def _unified() -> TrainConfig:
    """The unified training recipe (fusion_occ_occ3d_miou_unified.py:279-289):
    lr 2e-4, grad-accum 8, clip 35, 0.1 lr_mult on backbone/VT."""
    return TrainConfig(
        model=full_model_config(),
        optim=OptimConfig(lr=2e-4, clip_norm=35.0, accumulate_steps=8,
                          backbone_lr_mult=0.1))


def _wo_mask(base: Callable[[], TrainConfig] = None) \
        -> Callable[[], TrainConfig]:
    """wo_train_cam_mask: every voxel supervised."""
    def make() -> TrainConfig:
        c = (base or _baseline)()
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, use_mask=False,
                                         mask_mode='baseline_without_mask'))
    return make


def _wo_depth_sv(base: Callable[[], TrainConfig] = None) \
        -> Callable[[], TrainConfig]:
    """Depth-supervision ablation (…_wo_DepthSV.py:81: depth_loss_weight=0)."""
    def make() -> TrainConfig:
        c = (base or _baseline)()
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, depth_loss_weight=0.0))
    return make


def _hybrid_eval(base: Callable[[], TrainConfig]) \
        -> Callable[[], TrainConfig]:
    """The ori_setting evaluator (OccupancyMetricHybrid,
    fusion_occ_occ3d_miou_ori_setting.py:287): masked mIoU + RayIoU."""
    def make() -> TrainConfig:
        return dataclasses.replace(base(), eval=EvalConfig(metric='hybrid'))
    return make


def _mask_mode(mode: str, base: Callable[[], TrainConfig] = None,
               dist_c: float = 35.0) -> Callable[[], TrainConfig]:
    """Distance-condition mask ablations (reference
    fusion_occ_occ3d_miou_unified_condition_*.py — all on the unified
    recipe; the 20m variant only moves dist_threshold_c, …_C_20m.py:185)."""
    def make() -> TrainConfig:
        c = (base or _unified)()
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, mask_mode=mode,
                                         mask_dist_threshold_c=dist_c))
    return make


def _image_only() -> TrainConfig:
    c = _baseline()
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, use_lidar=False))


def _rayiou(base: Callable[[], TrainConfig]) -> Callable[[], TrainConfig]:
    """RayIoU eval protocol (fusion_occ_occ3d_rayiou_*.py): training keeps
    the camera mask, but evaluation drops it (visibility is handled by the
    ray casting itself) and scores RayIoU instead of masked mIoU."""
    def make() -> TrainConfig:
        return dataclasses.replace(
            base(), eval=EvalConfig(metric='rayiou', use_image_mask=False))
    return make


def _calib_train(base: Callable[[], TrainConfig] = None) \
        -> Callable[[], TrainConfig]:
    """Temperature-fitting run (…_unified_calib_train.py): the unified model
    evaluated on the val_calib split; tools/train_temperature.py fits T by
    NLL on its saved logits."""
    def make() -> TrainConfig:
        return dataclasses.replace((base or _unified)(),
                                   eval=EvalConfig(split='val_calib'))
    return make


def _calib_eval(temperature: float,
                base: Callable[[], TrainConfig] = None) \
        -> Callable[[], TrainConfig]:
    """Calibrated evaluation (…_unified_calib_eval.py: T=1.5221 fitted on
    val_calib, wo_mask variant T=1.8861; …_calib_eval_before.py: T=1 for
    the uncalibrated baseline), scored on the held-out val_eval split."""
    def make() -> TrainConfig:
        c = (base or _unified)()
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, temperature=temperature),
            eval=EvalConfig(split='val_eval'))
    return make


def _bevdet_occ_stereo() -> TrainConfig:
    """BEVDet-Occ stereo (BEVDet dev2.1, configs/bevdet_occ/
    bevdet-occ-stbase-4d-stereo-512x1408-24e.py): Swin-B as FusionOcc's,
    FPN_LSS 512+1024 -> 512, the stereo DepthNet at mid 512 (its input
    width) with ASPP 96, numC_Trans 32 at stride 16, FusionOcc's grid and
    depth bins, one adjacent frame, no LiDAR, trunk (1, 2, 4) layers.  The
    optimizer stays at the port's defaults."""
    return TrainConfig(model=full_model_config(
        use_lidar=False, lidar_out_channels=0, img_neck_out_channels=512,
        bev_num_layer=(1, 2, 4),
        vt=ViewTransformerConfig(in_channels=512, mid_channels=512,
                                 feature_channels=32, aspp_mid_channels=96,
                                 downsample=16)), optim=OptimConfig())


def _bevformer_occ() -> TrainConfig:
    """BEVFormer-Occ (Occ3D's projects/configs/bevformer/
    bevformer_base_occ.py): 6 cameras at 900x1600, FusionOcc's grid (the
    Occ3D-nuScenes 200x200x16 over [-40, 40] x [-40, 40] x [-1, 5.4]) and
    18 classes, no LiDAR; the model's own sizes are ``BEVFormerConfig``'s.
    The optimizer stays at the port's defaults (no training is ported)."""
    return TrainConfig(model=full_model_config(
        input_size=(900, 1600), use_lidar=False, lidar_out_channels=0),
        optim=OptimConfig())


def _tiny() -> TrainConfig:
    return TrainConfig(model=tiny_model_config(),
                       optim=OptimConfig(warmup_iters=10, iters_per_epoch=10))


# One preset per reference config file (25 files under
# projects/FusionOcc/configs/) plus aliases kept from earlier rounds and
# the beyond-reference extras.  File -> preset mapping: PARITY.md.
_UNIFIED_WO_MASK = _wo_mask(_unified)

CONFIGS: Dict[str, Callable[[], TrainConfig]] = {
    # --- the two base recipes ---
    'fusion_occ': _baseline,                       # fusion_occ.py
    'fusion_occ_unified': _unified,                # ..._miou_unified.py
    # ori_setting = baseline recipe + the hybrid evaluator
    # (..._miou_ori_setting.py:287 OccupancyMetricHybrid)
    'fusion_occ_miou_ori_setting': _hybrid_eval(_baseline),
    # --- camera-mask ablation (wo_train_cam_mask) ---
    'fusion_occ_wo_mask_ori_setting':
        _hybrid_eval(_wo_mask()),                  # ..._wo_train_cam_mask_ori_setting.py
    'fusion_occ_wo_mask': _wo_mask(),              # alias (baseline recipe)
    'fusion_occ_unified_wo_mask': _UNIFIED_WO_MASK,  # ..._wo_train_cam_mask_unified.py
    # --- depth-supervision ablation (unified recipe, …_unified_wo_DepthSV.py) ---
    'fusion_occ_unified_wo_depth_sv': _wo_depth_sv(_unified),
    'fusion_occ_unified_wo_depth_sv_rayiou': _rayiou(_wo_depth_sv(_unified)),
    'fusion_occ_unified_wo_mask_wo_depth_sv':
        _wo_depth_sv(_UNIFIED_WO_MASK),            # ..._wo_train_cam_mask_unified_wo_DepthSV.py
    'fusion_occ_unified_wo_mask_wo_depth_sv_rayiou':
        _rayiou(_wo_depth_sv(_UNIFIED_WO_MASK)),   # ..._wo_DepthSV_rayiou.py
    'fusion_occ_wo_depth_sv': _wo_depth_sv(),      # alias (baseline recipe)
    # --- distance-condition mask ablations (unified recipe) ---
    'fusion_occ_condition_C': _mask_mode('condition_C'),
    'fusion_occ_condition_C_20m': _mask_mode('condition_C', dist_c=20.0),
    'fusion_occ_condition_C_full': _mask_mode('condition_C_full'),
    'fusion_occ_condition_D': _mask_mode('condition_D'),
    'fusion_occ_condition_D_full': _mask_mode('condition_D_full'),
    'fusion_occ_condition_D_prime': _mask_mode('condition_D_prime'),
    # --- RayIoU protocol (fusion_occ_occ3d_rayiou_*.py) ---
    'fusion_occ_rayiou_ori_setting': _rayiou(_baseline),
    'fusion_occ_rayiou': _rayiou(_baseline),       # alias
    'fusion_occ_unified_rayiou': _rayiou(_unified),
    'fusion_occ_wo_mask_rayiou_ori_setting': _rayiou(_wo_mask()),
    'fusion_occ_wo_mask_rayiou': _rayiou(_wo_mask()),  # alias
    'fusion_occ_unified_wo_mask_rayiou': _rayiou(_UNIFIED_WO_MASK),
    # --- calibration (…_calib_{train,eval,eval_before}.py; fitted T:
    # unified 1.5221, wo_mask 1.8861 — reference *_calib_eval.py:73) ---
    'fusion_occ_calib_train': _calib_train(),
    'fusion_occ_calib_eval': _calib_eval(1.5221),
    'fusion_occ_calib_eval_before': _calib_eval(1.0),
    'fusion_occ_wo_mask_calib_train': _calib_train(_UNIFIED_WO_MASK),
    'fusion_occ_wo_mask_calib_eval': _calib_eval(1.8861, _UNIFIED_WO_MASK),
    'fusion_occ_wo_mask_calib_eval_before': _calib_eval(1.0, _UNIFIED_WO_MASK),
    # --- beyond-reference extras ---
    'fusion_occ_image_only': _image_only,
    'tiny': _tiny,
    # --- another architecture on the port's path ---
    'bevdet_occ_stbase_stereo': _bevdet_occ_stereo,
    'bevformer_base_occ': _bevformer_occ,
}

# presets whose model is not FusionOcc: name -> (module of models/, class)
ARCHITECTURES: Dict[str, Tuple[str, str]] = {
    'bevdet_occ_stbase_stereo': ('bevstereo_occ', 'BEVStereo4DOcc'),
    'bevformer_base_occ': ('bevformer_occ', 'BEVFormerOcc'),
}


def build_model(name: Optional[str] = None, device='cuda',
                model_cfg: Optional[ModelConfig] = None):
    """The model of preset ``name`` (FusionOcc for None and for every
    FusionOcc preset) on ``device``, built from ``model_cfg`` (a variant
    of the preset's, say at fp32) or else the preset's own."""
    if model_cfg is None:
        model_cfg = get_config(name).model
    module, cls = ARCHITECTURES.get(name, ('fusion_occ', 'FusionOcc'))
    return getattr(importlib.import_module(f'{__package__}.models.{module}'),
                   cls)(model_cfg, device=device)


def get_config(name: str, **overrides) -> TrainConfig:
    if name not in CONFIGS:
        raise KeyError(f'unknown config {name!r}; one of {sorted(CONFIGS)}')
    cfg = CONFIGS[name]()
    if overrides:
        model_keys = {f.name for f in dataclasses.fields(ModelConfig)}
        optim_keys = {f.name for f in dataclasses.fields(OptimConfig)}
        m = {k: v for k, v in overrides.items() if k in model_keys}
        o = {k: v for k, v in overrides.items() if k in optim_keys}
        t = {k: v for k, v in overrides.items()
             if k not in model_keys and k not in optim_keys}
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, **m) if m else cfg.model,
            optim=dataclasses.replace(cfg.optim, **o) if o else cfg.optim,
            **t)
    return cfg
