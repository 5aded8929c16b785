"""One training step of the reference: the loss, autograd, and the
optimizer of the preset's recipe written out plainly, parameter by
parameter: per group ``clip_by_global_norm`` (divided by the norm itself),
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), decoupled weight decay,
then ``-lr(count)`` with the schedule read at the count before the update
(linear warmup from ``lr * warmup_start_factor``, cosine decay after).
One group: the preset's ``backbone_lr_mult`` is 1."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .layers import random_scope
from .losses import total_loss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def learning_rate(opt, count: int) -> float:
    if count < opt.warmup_iters:
        start = opt.lr * opt.warmup_start_factor
        return start + (opt.lr - start) * count / opt.warmup_iters
    decay = max(opt.max_epochs * opt.iters_per_epoch - opt.warmup_iters, 1)
    c = min(count - opt.warmup_iters, decay)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
    return opt.lr * ((1.0 - opt.eta_min_factor) * cosine
                     + opt.eta_min_factor)


class AdamW:
    """The optimizer's state: moments by parameter name and the count."""

    def __init__(self, model: torch.nn.Module, opt):
        if opt.accumulate_steps != 1 or opt.backbone_lr_mult != 1.0:
            raise ValueError('the reference runs one group, no accumulation')
        self.opt, self.count = opt, 0
        self.params = dict(model.named_parameters())
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Apply the parameters' ``.grad``; return the clipped gradients
        the moments took, by name."""
        opt = self.opt
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in self.params.items()}
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = 1.0 if norm < opt.clip_norm else opt.clip_norm / norm
        lr = learning_rate(opt, self.count)
        self.count += 1
        bc1 = 1.0 - ADAM_B1 ** self.count
        bc2 = 1.0 - ADAM_B2 ** self.count
        clipped = {}
        for n, p in self.params.items():
            g = grads[n] * scale
            clipped[n] = g
            self.mu[n].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            self.nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            upd = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + ADAM_EPS)
            p.add_(upd + opt.weight_decay * p, alpha=-lr)
        return clipped


def train_step(model, cfg, optimizer: AdamW, batch, generator):
    """One step in place: (loss, the clipped gradients by name)."""
    model.train()
    with random_scope(generator):
        out = model(batch)
    loss, _ = total_loss(out, batch, cfg.model)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach(), optimizer.step()
