"""Both sides of a cell built from its configuration file and the seed:
the port's model (the system under test) and the plain reference, given
the same weights (``reference.weights.make_weights``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import inputs
from .inputs import generator
from .spec import build_dataclass


def port_config(conf: Dict[str, Any], defaulted=None):
    """The port's ``TrainConfig`` as the configuration file states it; the
    fields it leaves to the port's defaults are appended to ``defaulted``."""
    from fusionocc_tpu_torch.config import (ModelConfig, OptimConfig,
                                            TrainConfig)
    return TrainConfig(
        model=build_dataclass(ModelConfig, conf['model'], defaulted,
                              'model.'),
        optim=build_dataclass(OptimConfig, conf['optim'], defaulted,
                              'optim.'),
        batch_size=conf['batch_size'])


def reference_config(conf: Dict[str, Any]):
    """The reference's configuration: the file's, computed in float32."""
    from reference.config import ModelConfig, OptimConfig, TrainConfig
    model = build_dataclass(ModelConfig, conf['model'])
    model = dataclasses.replace(model, compute_dtype='float32')
    return TrainConfig(model=model,
                       optim=build_dataclass(OptimConfig, conf['optim']),
                       batch_size=conf['batch_size'])


CAMERA_BN = 'img_view_transformer.depth_seg_net.bn'


def camera_statistics(model_cfg, device) -> Dict[str, torch.Tensor]:
    """Running statistics of the BatchNorm on the 27-number camera vector
    (intrinsics, augmentation, key-frame pose): the mean and variance of
    the rig's six vectors, as training on this rig leaves them.  With 0
    and 1 the raw focal length (845 pixels) drives the MLPs of the depth,
    context and segmentation gates, and their sigmoid gates turn on
    bf16's rounding of those pre-activations."""
    from reference.geometry import get_mlp_input
    N = model_cfg.num_cams
    rig = inputs.camera_rig(N, device)[None]
    K = inputs.intrinsics(model_cfg.input_size, device).expand(1, N, 3, 3)
    eye = torch.eye(3, device=device)
    vec = get_mlp_input(rig, K, eye.expand(1, N, 3, 3),
                        torch.zeros(1, N, 3, device=device), eye[None])[0]
    var, mean = torch.var_mean(vec, dim=0, correction=0)
    return {CAMERA_BN + '.running_mean': mean,
            CAMERA_BN + '.running_var': var}


def seeded_weights(ref_cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    from reference.fusion_occ import FusionOcc
    from reference.weights import make_weights
    shell = FusionOcc(ref_cfg.model, device='meta')
    return make_weights(shell, generator(seed, 'weights', device), device,
                        camera_statistics(ref_cfg.model, device))


def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Load ``weights``; only buffers the model builds itself (the
    attention's index tables, BatchNorm counters) may be absent."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    bad = [k for k in missing if not k.endswith(
        ('relative_position_index', 'num_batches_tracked'))]
    if bad or unexpected:
        raise ValueError(f'weights do not fit: missing {bad}, unexpected '
                         f'{unexpected}')


def port_model(conf, seed: int, device, model_edit=None):
    """The port's FusionOcc with the seeded weights; ``model_edit`` maps
    the configuration's ``ModelConfig`` to the one run (a control's path
    switched on), if given."""
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    cfg = port_config(conf)
    if model_edit is not None:
        cfg = dataclasses.replace(cfg, model=model_edit(cfg.model))
    model = FusionOcc(cfg.model, device=device)
    load(model, seeded_weights(reference_config(conf), seed, device))
    return cfg, model


def reference_model(conf, seed: int, device, compute_dtype=None):
    """The reference FusionOcc in float32 (TF32 off), or in
    ``compute_dtype`` (a control's), with the same weights."""
    from reference.fusion_occ import FusionOcc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(conf)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=compute_dtype))
    model = FusionOcc(cfg.model, device=device)
    load(model, seeded_weights(cfg, seed, device))
    return cfg, model
