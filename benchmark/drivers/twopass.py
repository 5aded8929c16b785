"""Two-pass ``predict``, the evaluation's semantics: batch 1 in a closed
loop over ``frames`` samples of one scene made at set-up, each the key
frame and the frame before it (``frames + 1`` frames of one drive), the
key frame's pooling index built once for the rig (the evaluator's cache),
the adjacent frame's built in the call.

A unit is one predict: the call, then a synchronise.  The window keeps the
class ids of the last replay of the sampled samples; the reference runs
the same samples two-pass in float32.
"""
from __future__ import annotations

import torch

from harness import compare, inputs, program
from reference.counting import count_flops


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.cycle = self.traffic['frames']
        self.unit_samples = 1
        self.kept = {}
        self.flags = []

    def make_inputs(self):
        """The configuration, the samples and the sampled ones."""
        ctx, T = self.ctx, self.cycle
        self.cfg = program.port_config(ctx.conf)
        m = self.cfg.model
        self.scene = inputs.make_scene(m, T + 1, ctx.seed, ctx.device)
        self.fields = [inputs.frame_fields(m, self.scene, t + 1, [t])
                       for t in range(T)]
        g = inputs.generator(ctx.seed, 'sample', 'cpu')
        self.sample = sorted(torch.randperm(T, generator=g)[
            :self.traffic['compare_frames']].tolist())

    def setup(self):
        from fusionocc_tpu_torch.models.fusion_occ import (
            Batch, frame_pooling_index)
        ctx, T = self.ctx, self.cycle
        self.make_inputs()
        self.cfg, self.model = program.port_model(
            ctx.conf, ctx.seed, ctx.device, ctx.model_edit)
        m = self.cfg.model
        self.batches = [Batch(**f) for f in self.fields]
        b = self.batches[0]
        self.key_idx = frame_pooling_index(
            m, b.sensor2keyego[:, 0], b.intrins[:, 0], b.post_rots[:, 0],
            b.post_trans[:, 0], b.bda)
        for t in range(T):              # every sample's shapes, once
            self.step(t, keep=False)

    def modules(self):
        return {'img_backbone': self.model.img_backbone,
                'lidar_encoder': getattr(self.model, 'lidar_encoder', None)}

    def step(self, i: int, keep: bool = True, mark=None) -> None:
        t = i % self.cycle
        pred = self.model.predict(self.batches[t],
                                  pool_idxs=[self.key_idx, None])
        self.flags.append(pred.max() < self.cfg.model.num_classes)
        if keep and t in self.sample:
            self.kept[t] = (pred, None)

    def release(self):
        self.batches = self.model = self.key_idx = None
        self.flags = []

    @torch.inference_mode()
    def reference_outputs(self, ref, count: bool = False):
        """({t: float32 logits} of the sampled samples from a reference
        model; the FLOPs of one two-pass predict when ``count``)."""
        from reference.fusion_occ import Batch
        out, flops = {}, None
        for t in self.sample:
            b = Batch(**self.fields[t])
            if count and flops is None:
                flops = count_flops(lambda: ref(b))
            out[t] = ref(b)['occ_logits'].float()
        return out, flops

    def serve_reference(self, ref) -> None:
        """The sampled samples' class ids from a reference model in the
        port's place (the control)."""
        for t, logits in self.reference_outputs(ref)[0].items():
            self.kept[t] = (logits.argmax(-1).to(torch.uint8), None)

    def check(self, count: bool = False):
        r32, r16, flops = compare.reference_outputs(self, count)
        every = compare.served(self.kept, r32, r16)
        lim = self.traffic['limits']
        numbers = [(k, every[k], lim[k]) for k in lim]
        self.readings = {k: v for k, v in every.items() if k not in lim}
        numbers.append(('frames_missing',
                        float(len(self.sample) - len(self.kept)), 0.0))
        return numbers, flops
