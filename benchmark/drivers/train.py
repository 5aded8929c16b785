"""``train_step`` at batch 1, the preset's recipe, in a closed loop over
``batches`` distinct labelled batches made at set-up (each a key frame and
the frame before it from one drive, with voxel semantics, camera mask and
image semantics), cycled.

A unit is one step: the call, then a synchronise.  Set-up builds the model
and its optimizer state once and drives them through the first
``batches`` steps, the warm-up, through the same call and feed as the
window; of the first three it keeps each loss, each leaf's norm of the
first gradient as the optimizer took it (its first moment over 1 - b1)
and each leaf's norm of the parameters' change after the third.  The
reference follows those three steps in float32 from the same weights,
batches and random draws (the port's rule: a generator seeded by
(config seed, step) on the device).
"""
from __future__ import annotations

import dataclasses

import torch

from harness import compare, inputs, program
from reference.counting import count_flops

STEPS = 3           # the steps the reference follows


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.cycle = self.traffic['batches']
        self.unit_samples = 1
        self.flags = []

    def make_inputs(self):
        """The configuration and the labelled batches' fields."""
        ctx, T = self.ctx, self.cycle
        self.cfg = dataclasses.replace(program.port_config(ctx.conf),
                                       seed=ctx.seed % 2 ** 31)
        m = self.cfg.model
        self.scene = inputs.make_scene(m, T + 1, ctx.seed, ctx.device,
                                       labels=True)
        self.fields = [inputs.frame_fields(m, self.scene, t + 1, [t])
                       for t in range(T)]

    def setup(self):
        from fusionocc_tpu_torch.models.fusion_occ import Batch
        from fusionocc_tpu_torch.train import loop
        ctx, T = self.ctx, self.cycle
        self.make_inputs()
        cfg, self.model = program.port_model(
            ctx.conf, ctx.seed, ctx.device, ctx.model_edit)
        self.cfg = dataclasses.replace(cfg, seed=self.cfg.seed)
        self.batches = [Batch(**f) for f in self.fields]
        self.state = loop.create_train_state(self.model, self.cfg)
        params = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        self.losses = []
        for t in range(T):
            self.step(t, keep=t < STEPS)
            if t == 0:
                mu = {n: m_ for g in self.state.groups
                      for n, m_ in zip(g.names, g.mu)}
                self.grad = {n: float(mu[n].norm() / (1 - loop.ADAM_B1))
                             for n in params}
            if t == STEPS - 1:
                self.change = {n: float((p.detach() - start[n]).norm())
                               for n, p in params.items()}
                del start

    def modules(self):
        return {'img_backbone': self.model.img_backbone,
                'lidar_encoder': getattr(self.model, 'lidar_encoder', None)}

    def step(self, i: int, keep: bool = True, mark=None) -> None:
        from fusionocc_tpu_torch.train import loop
        t = i % self.cycle
        logs = loop.train_step(self.model, self.cfg, self.state,
                               self.batches[t], mark)
        self.flags.append(torch.isfinite(logs['loss']))
        if keep and len(self.losses) < STEPS:
            self.losses.append(float(logs['loss']))

    def release(self):
        self.batches = self.model = self.state = None
        self.flags = []

    def check(self, count: bool = False):
        ctx = self.ctx
        ref_cfg, ref = program.reference_model(ctx.conf, ctx.seed,
                                               ctx.device)
        r = follow(ref, ref_cfg, self.cfg.seed, self.fields, ctx.device,
                   count)
        keep = compare.kept_leaves(r['grad'])
        gaps = [abs(a - b) / abs(b) for a, b in zip(self.losses, r['losses'])]
        every = {
            'loss_gap': gaps[0] if gaps else float('nan'),
            'change_gap': compare.median_leaf_gap(self.change, r['change'],
                                                  keep),
            'change_gap_worst': compare.leaf_gaps(self.change, r['change'],
                                                  keep),
            'grad_gap': compare.median_leaf_gap(self.grad, r['grad'], keep),
            'grad_gap_worst': compare.leaf_gaps(self.grad, r['grad'], keep)}
        # the rest is read, not compared: no control or fault reads it 3x
        # farther than sound runs do (PERF.md)
        lim = self.traffic['limits']
        numbers = [(k, every[k], lim[k]) for k in lim]
        self.readings = {k: v for k, v in every.items() if k not in lim}
        self.readings['loss_gap_steps'] = gaps
        numbers.append(('steps_missing',
                        float(STEPS - len(self.losses[:STEPS])), 0.0))
        return numbers, r['flops']


def follow(ref, ref_cfg, seed: int, fields, device, count: bool = False,
           fp8: bool = False):
    """The reference's first ``STEPS`` steps: losses, each leaf's norm of
    the first clipped gradient and of the change after the last step;
    with ``fp8`` its products one precision below (the control)."""
    import contextlib

    from reference.layers import fp8_products
    with fp8_products() if fp8 else contextlib.nullcontext():
        return _follow(ref, ref_cfg, seed, fields, device, count)


def _follow(ref, ref_cfg, seed, fields, device, count):
    from reference import optim
    from reference.fusion_occ import Batch
    opt = optim.AdamW(ref, ref_cfg.optim)
    start = {n: p.detach().clone() for n, p in ref.named_parameters()}
    out = {'losses': [], 'flops': None}
    for s in range(STEPS):
        g = torch.Generator(device=device).manual_seed(seed * 2 ** 32 + s)
        b = Batch(**fields[s])
        if count and s == 0:
            box = {}
            out['flops'] = count_flops(lambda: box.update(
                r=optim.train_step(ref, ref_cfg, opt, b, g)))
            loss, clipped = box['r']
        else:
            loss, clipped = optim.train_step(ref, ref_cfg, opt, b, g)
        out['losses'].append(float(loss))
        if s == 0:
            out['grad'] = {n: float(v.norm()) for n, v in clipped.items()}
    out['change'] = {n: float((p.detach() - start[n]).norm())
                     for n, p in ref.named_parameters()}
    return out
