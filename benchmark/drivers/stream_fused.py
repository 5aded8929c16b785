"""The stream driver (``drivers/stream.py``) with the LiDAR encoder's
eval option ``lidar.zwin_fuse`` on: K3 with its fused epilogue
(``zwin_conv_epi``: the BatchNorm, ReLU and lane mask in the kernel) in
place of the unfused chain.  The option is composed before the run's own
``model_edit``, so a control still applies on top; the reference is the
stream driver's (the fused epilogue computes the same function).
"""
from __future__ import annotations

import dataclasses
import types

from harness import spec

stream = spec.load_module(spec.driver_path('stream'), 'driver_stream')


def zwin_fuse(model_cfg):
    return dataclasses.replace(model_cfg, lidar=dataclasses.replace(
        model_cfg.lidar, zwin_fuse=True))


class Driver(stream.Driver):
    def __init__(self, ctx):
        outer = ctx.model_edit
        super().__init__(types.SimpleNamespace(**dict(
            vars(ctx), model_edit=zwin_fuse if outer is None else
            (lambda m: outer(zwin_fuse(m))))))
