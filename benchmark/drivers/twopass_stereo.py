"""Two-pass ``predict`` of BEVStereo4D-Occ (``models/bevstereo_occ.py``),
the evaluation's semantics: batch 1 in a closed loop over ``frames``
samples of one scene made at set-up (``frames + 2`` frames of one drive),
each the key frame, the adjacent frame and the stereo reference frame
before them; the key frame's pooling index built once for the rig (the
evaluator's cache), the adjacent frame's index and both cost volumes'
sampling grids built in the call.  A unit is one predict (12 full Swin-B
images, 6 stage-0 images, 2 plane sweeps), then a synchronise.

The port's model and the plain reference (``reference/bevstereo_occ.py``)
get the same seeded weights (``reference.weights.make_weights`` on the
reference's shell, the camera BatchNorm under
``img_view_transformer.depth_net.bn`` holding the rig's statistics).  The
window keeps the class ids of the last replay of the sampled samples; the
reference runs the same samples in float32 and in the configuration's
precision, and ``compare.served`` gives ``gap_excess``.  ``modules()``
names Swin-B (``img_backbone``) and the plane sweep (``cost_volume``) for
the forward-hook clocks.

The port's module is imported at the top of ``setup()``: a checkout
without it fails there, within seconds.
"""
from __future__ import annotations

import dataclasses

import torch

from harness import compare, inputs, program, spec

twopass = spec.load_module(spec.driver_path('twopass'), 'driver_twopass')
CAMERA_BN = 'img_view_transformer.depth_net.bn'


def seeded_weights(ref_cfg, seed: int, device):
    """The state dict both sides load: the reference's structure, the seed's
    draws, the rig's camera statistics."""
    from reference.bevstereo_occ import BEVStereo4DOcc
    from reference.weights import make_weights
    stats = {k.replace(program.CAMERA_BN, CAMERA_BN): v for k, v in
             program.camera_statistics(ref_cfg.model, device).items()}
    shell = BEVStereo4DOcc(ref_cfg.model, device='meta')
    return make_weights(shell, inputs.generator(seed, 'weights', device),
                        device, stats)


def reference_model(conf, seed: int, device, compute_dtype=None):
    """The reference in float32 (TF32 off), or in ``compute_dtype``."""
    from reference.bevstereo_occ import BEVStereo4DOcc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = program.reference_config(conf)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=compute_dtype))
    model = BEVStereo4DOcc(cfg.model, device=device)
    program.load(model, seeded_weights(cfg, seed, device))
    return cfg, model


class Driver(twopass.Driver):
    def make_inputs(self):
        """The configuration, the samples and the sampled ones."""
        ctx, T = self.ctx, self.cycle
        self.cfg = program.port_config(ctx.conf)
        m = self.cfg.model
        self.scene = inputs.make_scene(m, T + 2, ctx.seed, ctx.device)
        self.fields = [inputs.frame_fields(m, self.scene, t + 2, [t + 1, t])
                       for t in range(T)]
        g = inputs.generator(ctx.seed, 'sample', 'cpu')
        self.sample = sorted(torch.randperm(T, generator=g)[
            :self.traffic['compare_frames']].tolist())

    def setup(self):
        from fusionocc_tpu_torch.models.bevstereo_occ import BEVStereo4DOcc
        from fusionocc_tpu_torch.models.fusion_occ import (
            Batch, frame_pooling_index)
        ctx = self.ctx
        self.make_inputs()
        if ctx.model_edit is not None:
            self.cfg = dataclasses.replace(
                self.cfg, model=ctx.model_edit(self.cfg.model))
        m = self.cfg.model
        self.model = BEVStereo4DOcc(m, device=ctx.device)
        program.load(self.model, seeded_weights(
            program.reference_config(ctx.conf), ctx.seed, ctx.device))
        self.batches = [Batch(**f) for f in self.fields]
        b = self.batches[0]
        self.key_idx = frame_pooling_index(
            m, b.sensor2keyego[:, 0], b.intrins[:, 0], b.post_rots[:, 0],
            b.post_trans[:, 0], b.bda)
        for t in range(self.cycle):     # every sample's shapes, once
            self.step(t, keep=False)

    def modules(self):
        return {'img_backbone': self.model.img_backbone,
                'cost_volume': self.model.img_view_transformer.cost_volume}

    def references(self, count: bool = False):
        """The sampled samples' logits from the float32 reference (its
        FLOPs of one unit when ``count``) and from the reference in the
        configuration's precision, each built, run and freed in turn."""
        ctx = self.ctx
        outs = []
        for prec in (None, self.cfg.model.compute_dtype):
            _, ref = reference_model(ctx.conf, ctx.seed, ctx.device, prec)
            outs.append(self.reference_outputs(ref, count and prec is None))
            del ref
            if ctx.cuda:
                torch.cuda.empty_cache()
        (r32, flops), (r16, _) = outs
        return r32, r16, flops

    def check(self, count: bool = False):
        r32, r16, flops = self.references(count)
        every = compare.served(self.kept, r32, r16)
        lim = self.traffic['limits']
        numbers = [(k, every[k], lim[k]) for k in lim]
        self.readings = {k: v for k, v in every.items() if k not in lim}
        numbers.append(('frames_missing',
                        float(len(self.sample) - len(self.kept)), 0.0))
        return numbers, flops

