"""``predict_streaming`` frame by frame, as a car runs it: one stream at
batch 1 in a closed loop over a scene of ``frames`` key frames made at
set-up and replayed, the cache reset at the scene's first frame, the key
frame's pooling index built once for the rig (the evaluator's cache).

A unit is one frame: the call, then a synchronise, so its latency ends
when its class ids are on the device.  The window keeps, for the sampled
positions of the scene, the class ids and logits of their last replay; the
reference then computes each sampled frame from the previous frame's
camera feature (the cache holds nothing else) and frame itself.
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
        """The configuration, the scene and the sampled positions."""
        ctx, T = self.ctx, self.cycle
        self.cfg = program.port_config(ctx.conf)
        m = self.cfg.model
        self.scene = inputs.make_scene(m, T, ctx.seed, ctx.device)
        self.fields = [inputs.frame_fields(m, self.scene, t, [])
                       for t in range(T)]
        g = inputs.generator(ctx.seed, 'sample', 'cpu')
        k = self.traffic['compare_frames']
        self.sample = sorted({0, *(1 + torch.randperm(T - 1, generator=g)[
            :k - 1]).tolist()})

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
        self.pool_idx = frame_pooling_index(
            m, b.sensor2keyego[:, 0], b.intrins[:, 0], b.post_rots[:, 0],
            b.post_trans[:, 0], b.bda)
        self.reset = (torch.ones(1, dtype=torch.bool, device=ctx.device),
                      torch.zeros(1, dtype=torch.bool, device=ctx.device))
        self.state = self.model.init_streaming_state(1)
        for t in range(T):              # every frame's shapes, once
            self.step(t, keep=False)

    def modules(self):
        return {'img_backbone': self.model.img_backbone,
                'lidar_encoder': getattr(self.model, 'lidar_encoder', None)}

    def step(self, i: int, keep: bool = True, mark=None) -> None:
        t = i % self.cycle
        pred, out, self.state = self.model.predict_streaming(
            self.batches[t], self.state, self.pool_idx,
            self.reset[0] if t == 0 else self.reset[1])
        self.flags.append(torch.isfinite(out['occ_logits']).all())
        if keep and t in self.sample:
            self.kept[t] = (pred, out['occ_logits'])

    def release(self):
        self.batches = self.model = self.state = self.pool_idx = None
        self.flags = []

    def cache_of(self, ref, t: int):
        """What a reference model's cache holds at position ``t``: the
        previous frame's camera feature, its pose, and whether it is valid
        (not at the scene's first frame)."""
        from reference.fusion_occ import Batch
        dev = self.ctx.device
        if t == 0:
            gx, gy, gz = self.cfg.model.grid.grid_size
            return (torch.zeros(1, gz, gy, gx, self.cfg.model.img_channels,
                                device=dev),
                    torch.eye(4, device=dev)[None],
                    torch.zeros(1, dtype=torch.bool, device=dev))
        return (ref.camera_voxel(Batch(**self.fields[t - 1])),
                self.scene['ego2global'][t - 1][None],
                torch.ones(1, dtype=torch.bool, device=dev))

    @torch.inference_mode()
    def reference_outputs(self, ref, count: bool = False):
        """({t: float32 logits} of the sampled frames from a reference model,
        each from the model's own cache; the FLOPs of one streamed frame
        when ``count``)."""
        from reference.fusion_occ import Batch
        out, flops = {}, None
        for t in self.sample:
            b, args = Batch(**self.fields[t]), self.cache_of(ref, t)
            if count and flops is None and t > 0:
                flops = count_flops(lambda: ref.streaming_logits(b, *args))
            out[t] = ref.streaming_logits(b, *args).float()
        return out, flops

    def serve_reference(self, ref) -> None:
        """The sampled frames from a reference model in the port's place
        (the control)."""
        for t, logits in self.reference_outputs(ref)[0].items():
            self.kept[t] = (logits.argmax(-1).to(torch.uint8), logits)

    def check(self, count: bool = False):
        r32, r16, flops = compare.reference_outputs(self, count)
        every = compare.served(self.kept, r32, r16)
        lim = self.traffic['limits']
        numbers = [(k, every[k], lim[k]) for k in lim]
        self.readings = {k: v for k, v in every.items() if k not in lim}
        numbers.append(('frames_missing',
                        float(len(self.sample) - len(self.kept)), 0.0))
        return numbers, flops
