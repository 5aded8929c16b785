"""``predict_streaming`` of BEVFormer-Occ (``models/bevformer_occ.py``)
frame by frame, as a car runs it: the stream driver's loop (one stream at
batch 1, closed loop over a scene of ``frames`` key frames made at set-up
and replayed, the state reset at the scene's first frame) with the
previous BEV as the state, the can-bus deltas from the scene's poses, and
spatial cross-attention's re-batch index built once for the rig
(``rig_index``, in the pooling index's place).

The scene is the stream driver's poses and images, without the LiDAR
sweeps and sparse depth the model does not read.  The configuration
file's ``bevformer`` key holds the model's own sizes
(``BEVFormerConfig``, built with ``spec.build_dataclass``).  The port's
model and the plain reference (``reference/bevformer_occ.py``) get the
same seeded weights: ``reference.weights.make_weights`` on the reference's
shell less its learned tables, then the tables from the same generator
(the BEV queries and the level and camera embeddings normal, the
positional rows and columns uniform in [0, 1), mmdet's init).  The
offset layers give offsets of a few pixels, as a trained model's do:
He's scale gives DCNv2 offsets of 20-40 px RMS, since the backbone's
activations grow from about 15 to over 1000 RMS through its residual
stacks under the frozen statistics, so each ``conv_offset`` is scaled in
turn, on a noise image, by the power of two that brings its offsets' RMS
nearest ``OFFSET_PX`` (``scale_offsets``); the deformable attentions'
``sampling_offsets`` keep their He weights (about 1.4 px RMS on the
normed queries) and take BEVFormer's bias, each head's points along its
own direction at 1, 2, ... px.  The window
keeps the class ids and logits of the sampled frames' last replay; the
check runs the reference's own chain from frame 0 to the last sampled
frame, once in float32 and once in the configuration's precision, each
with its own previous BEV, so a fault in the state shows, and
``compare.served`` gives ``logit_excess`` and ``gap_excess``.
``modules()`` names the backbone (``img_backbone``), the encoder
(``bev_encoder``) and the 12 samplings of a frame (``msda.tsa.<i>``,
``msda.sca.<i>``: the ``ms_deform_attn`` calls alone) for the
forward-hook clocks.

The port's module is imported at the top of ``setup()``: a checkout
without it fails there, within seconds.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from harness import compare, inputs, program, spec
from reference.counting import count_flops

stream = spec.load_module(spec.driver_path('stream'), 'driver_stream')
UNIFORM = ('row_embed', 'col_embed')     # mmdet's uniform_init
OFFSET_PX = 2.0                 # DCNv2's offsets' RMS, to a power of two


def reference_bev(conf):
    """The reference's ``BEVFormerConfig`` as the file states it."""
    from reference.bevformer_occ import BEVFormerConfig
    return spec.build_dataclass(BEVFormerConfig, conf['bevformer'])


def seeded_weights(model_cfg, bev, seed: int, device):
    """The state dict both sides load: the reference's structure, the
    seed's draws."""
    from reference.bevformer_occ import BEVFormerOcc
    from reference.weights import make_weights
    shell = BEVFormerOcc(model_cfg, bev, device='meta')
    g = inputs.generator(seed, 'weights', device)
    out = make_weights(nn.ModuleDict({k: m for k, m in shell.named_children()
                                      if k != 'embeds'}), g, device)
    for name, p in shell.embeds.named_parameters():
        draw = torch.rand if name in UNIFORM else torch.randn
        out['embeds.' + name] = draw(p.shape, generator=g, device=device)
    for name in out:
        if name.endswith('sampling_offsets.bias'):
            out[name] = offset_grid(bev, name, device)
    scale_offsets(model_cfg, bev, out, g, device)
    return out


@torch.no_grad()
def scale_offsets(model_cfg, bev, out, g, device) -> None:
    """Each DCNv2 ``conv_offset`` of ``out``, in the backbone's order,
    times the power of two that brings its offsets' RMS nearest
    ``OFFSET_PX`` on a noise image of a quarter of the padded size from
    ``g``, the layers after it seeing the scaled offsets; in float32 with
    deterministic convolutions, so every call gives the same weights."""
    from reference.bevformer_occ import ResNet, padded_hw
    net = ResNet(bev).to(device)
    pre = 'img_backbone.'
    net.load_state_dict({k[len(pre):]: v for k, v in out.items()
                         if k.startswith(pre)})

    def hook(mod, args, o):
        rms = o[:, :o.shape[1] * 2 // 3].float().pow(2).mean().sqrt()
        s = 2.0 ** round(math.log2(OFFSET_PX / max(float(rms), 1e-12)))
        for p in mod.parameters():
            p.mul_(s)
        return o * s

    hooks = [m.register_forward_hook(hook) for n, m in net.named_modules()
             if n.endswith('conv_offset')]
    ph, pw = padded_hw(model_cfg, bev)
    x = torch.rand((1, 3, max(ph // 4, 32), max(pw // 4, 32)), generator=g,
                   device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            net(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for h in hooks:
        h.remove()
    for k, v in net.state_dict().items():
        if 'conv_offset' in k:
            out[pre + k] = v


def offset_grid(bev, name: str, device) -> torch.Tensor:
    """BEVFormer's ``sampling_offsets`` bias: head h's points along the
    angle 2 pi h / heads, scaled to the unit square, the i-th at i + 1 px,
    the same at every level (and at both frames of temporal attention)."""
    H = bev.num_heads
    tsa = '.attentions.0.' in name
    levels = 2 if tsa else bev.num_levels
    P = bev.tsa_points if tsa else bev.sca_points
    theta = torch.arange(H, device=device) * (2 * math.pi / H)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    steps = torch.arange(1, P + 1, device=device, dtype=grid.dtype)
    return (grid[:, None, None] * steps[None, None, :, None]).expand(
        H, levels, P, 2).reshape(-1)


def reference_model(conf, seed: int, device, compute_dtype=None):
    """The reference in float32 (TF32 off), or in ``compute_dtype``."""
    from reference.bevformer_occ import BEVFormerOcc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = program.reference_config(conf)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=compute_dtype))
    bev = reference_bev(conf)
    model = BEVFormerOcc(cfg.model, bev, device=device)
    program.load(model, seeded_weights(cfg.model, bev, seed, device))
    return cfg, model


class Driver(stream.Driver):
    def make_inputs(self):
        """The stream driver's scene less what BEVFormer-Occ does not read:
        the poses and images drawn as ``inputs.make_scene`` draws them, the
        LiDAR sweeps and the sparse depth zeros (no ray casting)."""
        ctx, T = self.ctx, self.cycle
        self.cfg = program.port_config(ctx.conf)
        m = self.cfg.model
        N, (H, W) = m.num_cams, m.input_size
        dev = ctx.device
        self.scene = {
            'ego2global': inputs.ego_path(
                T, inputs.generator(ctx.seed, 'scene', dev), dev),
            'imgs': torch.rand((T, N, H, W, 3), device=dev,
                               generator=inputs.generator(ctx.seed, 'images',
                                                          dev)),
            'points': torch.zeros(1, 1, 5, device=dev).expand(T, 1, 5),
            'points_mask': torch.zeros(1, 1, dtype=torch.bool,
                                       device=dev).expand(T, 1),
            'sparse_depth': torch.zeros(1, N, H, W, device=dev).expand(
                T, N, H, W)}
        self.fields = [inputs.frame_fields(m, self.scene, t, [])
                       for t in range(T)]
        g = inputs.generator(ctx.seed, 'sample', 'cpu')
        k = self.traffic['compare_frames']
        self.sample = sorted({0, *(1 + torch.randperm(T - 1, generator=g)[
            :k - 1]).tolist()})

    def setup(self):
        from fusionocc_tpu_torch.config import BEVFormerConfig
        from fusionocc_tpu_torch.models.bevformer_occ import BEVFormerOcc
        from fusionocc_tpu_torch.models.fusion_occ import Batch
        ctx = self.ctx
        self.make_inputs()
        if ctx.model_edit is not None:
            self.cfg = dataclasses.replace(
                self.cfg, model=ctx.model_edit(self.cfg.model))
        self.model = BEVFormerOcc(
            self.cfg.model, ctx.device,
            spec.build_dataclass(BEVFormerConfig, ctx.conf['bevformer']))
        program.load(self.model, seeded_weights(
            program.reference_config(ctx.conf).model,
            reference_bev(ctx.conf), ctx.seed, ctx.device))
        self.batches = [Batch(**f) for f in self.fields]
        self.pool_idx = self.model.rig_index(self.batches[0])
        self.reset = (torch.ones(1, dtype=torch.bool, device=ctx.device),
                      torch.zeros(1, dtype=torch.bool, device=ctx.device))
        self.state = self.model.init_streaming_state(1)
        for t in range(2):      # every shape: a scene's start, then history
            self.step(t, keep=False)

    def modules(self):
        out = {'img_backbone': self.model.img_backbone,
               'bev_encoder': self.model.encoder}
        for i, layer in enumerate(self.model.encoder.layers):
            tsa, sca = layer.attentions
            out[f'msda.tsa.{i}'] = tsa.sampling
            out[f'msda.sca.{i}'] = sca.deformable_attention.sampling
        return out

    @torch.inference_mode()
    def reference_outputs(self, ref, count: bool = False):
        """({t: float32 logits} of the sampled frames from a reference
        model's own chain from frame 0; the FLOPs of one streamed frame
        with history when ``count``)."""
        from reference.fusion_occ import Batch
        out, flops, prev = {}, None, None
        for t in range(max(self.sample) + 1):
            b = Batch(**self.fields[t])
            if count and flops is None and prev is not None:
                flops = count_flops(lambda: ref.frame(b, prev))
            logits, bev = ref.frame(b, prev)
            prev = (bev, b.ego2global.float())
            if t in self.sample:
                out[t] = logits.float()
        return out, flops

    def references(self, count: bool = False):
        """The sampled frames' logits from the float32 reference (its FLOPs
        of one frame when ``count``) and from the reference in the
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
