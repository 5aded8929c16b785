"""Training: the optimizer, the LR schedule, EMA, gradient accumulation and
the train and eval steps.

Port of ``fusionocc_tpu/train/loop.py``.  The optimizer is optax's chain,
written out so that it matches optax where torch's built-ins differ:

- per parameter group, ``clip_by_global_norm(clip_norm)`` (the group's own
  norm: under ``multi_transform`` each group is clipped alone; optax divides
  by the norm itself, not by norm + 1e-6 as ``clip_grad_norm_`` does), then
  Adam (b1 0.9, b2 0.999, eps 1e-8), then decoupled weight decay on every
  parameter, then ``-lr(count) * lr_mult``;
- the schedule (``make_lr_schedule``) is read at the count *before* the
  update, so the first step uses ``lr * warmup_start_factor``;
- ``backbone_lr_mult != 1`` puts ``img_backbone`` and
  ``img_view_transformer`` in a second group (``LOW_LR_ROOTS``);
- ``accumulate_steps = k > 1`` follows ``optax.MultiSteps``: each call folds
  its gradients into a running mean, the parameters stay as they are until
  the k-th call applies the mean, and the schedule and Adam count applied
  steps only.

The EMA of the parameters moves on every call, micro-steps included, as
JAX's ``train_step`` does.  ``grad_norm`` is the global norm of the call's
raw gradients, before clipping.  A step's random draws come from a
generator seeded by (``TrainConfig.seed``, step), as JAX folds the step
into its key, so a resumed run draws what the uninterrupted one would.

Over several processes (``parallel.mesh``; the JAX package's data mesh)
each rank runs ``train_step`` on its rows of the global batch.  Its loss is
its part of the global loss (``train/losses.py``), so after the backward
every gradient is summed over the ranks (``all_reduce_gradients``), on
every call, accumulation steps included: each of ``MultiSteps``'s micro
gradients is already the global one in JAX.  The optimizer, the clipping,
``grad_norm`` and the EMA then run alike on every rank, whose parameters
stay bit-identical.  The logged losses are summed over the ranks: the
global batch's.

Under the hybrid mesh (``parallel.hybrid.HybridFusionOcc(cfg,
hybrid_mesh(...))``, JAX's ``create_train_state(..., mesh=)``) each rank's
loss is that of its
cameras' depth and seg and of its Y rows' occupancy, each over the global
count; the gradients of the modules every spatial rank runs (the LiDAR
encoder, ``pre_process_net``) are each rank's part through its own Y rows,
so the same sum over every rank counts each once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..config import OptimConfig, TrainConfig, check_train_supported
from ..models.fusion_occ import Batch, FusionOcc
from ..nn.layers import random_scope
from ..parallel import mesh
from .losses import total_loss

LOW_LR_ROOTS = ('img_backbone', 'img_view_transformer')
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_lr_schedule(opt: OptimConfig) -> Callable[[int], float]:
    """Linear warmup from ``lr * warmup_start_factor`` to ``lr`` over
    ``warmup_iters`` steps, then cosine decay to ``lr * eta_min_factor``
    over the rest of ``max_epochs * iters_per_epoch`` (optax's
    ``join_schedules`` of ``linear_schedule`` and
    ``cosine_decay_schedule``)."""
    total = opt.max_epochs * opt.iters_per_epoch
    decay_steps = max(total - opt.warmup_iters, 1)
    start = opt.lr * opt.warmup_start_factor

    def schedule(count: int) -> float:
        if count < opt.warmup_iters:
            frac = 1.0 - max(count, 0) / opt.warmup_iters
            return (start - opt.lr) * frac + opt.lr
        c = min(count - opt.warmup_iters, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return opt.lr * ((1.0 - opt.eta_min_factor) * cosine
                         + opt.eta_min_factor)
    return schedule


@dataclass
class ParamGroup:
    """Parameters sharing one clip norm and LR multiplier, with their Adam
    moments."""
    names: List[str]
    lr_mult: float
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class TrainState:
    """step: train_step calls (micro-steps included, JAX's ``state.step``);
    count: applied updates (Adam's and the schedule's count); ema: the
    parameters' EMA by name; acc and mini_step: the accumulated gradient
    mean and the calls folded into it (empty when accumulate_steps is 1)."""
    groups: List[ParamGroup]
    ema: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0
    count: int = 0
    mini_step: int = 0

    def state_dict(self) -> dict:
        return {'step': self.step, 'count': self.count,
                'mini_step': self.mini_step,
                'mu': {n: m for g in self.groups
                       for n, m in zip(g.names, g.mu)},
                'nu': {n: v for g in self.groups
                       for n, v in zip(g.names, g.nu)},
                'ema': self.ema, 'acc': self.acc}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.step, self.count = sd['step'], sd['count']
        self.mini_step = sd['mini_step']
        for g in self.groups:
            for n, m, v in zip(g.names, g.mu, g.nu):
                m.copy_(sd['mu'][n])
                v.copy_(sd['nu'][n])
        for table in ('ema', 'acc'):
            for n, t in getattr(self, table).items():
                t.copy_(sd[table][n])


def param_groups(model: torch.nn.Module, opt: OptimConfig
                 ) -> Dict[str, List[str]]:
    """Parameter names by group: 'base', and 'low' (``LOW_LR_ROOTS``) when
    ``backbone_lr_mult`` is not 1."""
    groups: Dict[str, List[str]] = {'base': [], 'low': []}
    for name, _ in model.named_parameters():
        low = (opt.backbone_lr_mult != 1.0
               and name.split('.', 1)[0] in LOW_LR_ROOTS)
        groups['low' if low else 'base'].append(name)
    return {k: v for k, v in groups.items() if v}


@torch.no_grad()
def create_train_state(model: FusionOcc, cfg: TrainConfig) -> TrainState:
    """Zero moments, the EMA a copy of the parameters, and an accumulator
    when ``accumulate_steps`` > 1."""
    check_train_supported(cfg)
    params = dict(model.named_parameters())
    mults = {'base': 1.0, 'low': cfg.optim.backbone_lr_mult}
    groups = [ParamGroup(names, mults[key],
                         [torch.zeros_like(params[n]) for n in names],
                         [torch.zeros_like(params[n]) for n in names])
              for key, names in param_groups(model, cfg.optim).items()]
    ema = {n: p.detach().clone() for n, p in params.items()}
    acc = ({n: torch.zeros_like(p) for n, p in params.items()}
           if cfg.optim.accumulate_steps > 1 else {})
    return TrainState(groups, ema, acc)


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's random draws."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + step)


def compute_loss(model: FusionOcc, cfg: TrainConfig, batch: Batch,
                 generator: torch.Generator):
    """The training forward and the loss: (loss, logs)."""
    model.train()
    with random_scope(generator):
        out = model(batch)
    return total_loss(out, model.local_targets(batch), cfg.model)


@torch.no_grad()
def apply_gradients(model: FusionOcc, opt: OptimConfig, state: TrainState
                    ) -> torch.Tensor:
    """Fold the parameters' ``.grad`` into the state, update the parameters
    when an accumulation window closes, move the EMA; return the raw
    gradients' global norm."""
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    grad_norm = global_norm(grads.values())
    state.step += 1
    if opt.accumulate_steps > 1:
        for n, a in state.acc.items():
            a.add_((grads[n] - a) / (state.mini_step + 1))
        state.mini_step += 1
        emit = state.mini_step == opt.accumulate_steps
        if emit:
            grads = {n: a.clone() for n, a in state.acc.items()}
            for a in state.acc.values():
                a.zero_()
            state.mini_step = 0
    else:
        emit = True
    if emit:
        lr = make_lr_schedule(opt)(state.count)
        state.count += 1
        bc1 = 1.0 - ADAM_B1 ** state.count
        bc2 = 1.0 - ADAM_B2 ** state.count
        for group in state.groups:
            g = [grads[n] for n in group.names]
            p = [params[n] for n in group.names]
            norm = global_norm(g)
            scale = torch.where(norm < opt.clip_norm, 1.0,
                                opt.clip_norm / norm)
            g = torch._foreach_mul(g, scale)
            torch._foreach_mul_(group.mu, ADAM_B1)
            torch._foreach_add_(group.mu, g, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(group.nu, ADAM_B2)
            torch._foreach_addcmul_(group.nu, g, g, value=1.0 - ADAM_B2)
            denom = torch._foreach_sqrt(torch._foreach_div(group.nu, bc2))
            torch._foreach_add_(denom, ADAM_EPS)
            upd = torch._foreach_div(torch._foreach_div(group.mu, bc1),
                                     denom)
            torch._foreach_add_(upd, p, alpha=opt.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr * group.lr_mult)
    decay = 1.0 - opt.ema_momentum
    names = list(state.ema)
    ema = [state.ema[n] for n in names]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[n] for n in names], alpha=1.0 - decay)
    return grad_norm


def train_step(model: FusionOcc, cfg: TrainConfig, state: TrainState,
               batch: Batch, mark: Optional[Callable[[str], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step in place on ``model`` and ``state``; returns
    the logs (``loss`` and its terms, ``grad_norm``) as tensors, those of
    the global batch inside a process group.  ``mark``, if given, is called
    with 'forward', 'backward' (the gradients' reduction included) and
    'optimizer' as each part is queued (a timer's hook)."""
    mark = mark or (lambda part: None)
    device = next(model.parameters()).device
    loss, logs = compute_loss(model, cfg, batch,
                              step_generator(cfg.seed, state.step, device))
    mark('forward')
    model.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_gradients(list(model.parameters()))
    mark('backward')
    keys = list(logs)
    logs = dict(zip(keys, mesh.all_reduce_sum(
        torch.stack([logs[k].detach() for k in keys]), 'loss').unbind()))
    logs['grad_norm'] = apply_gradients(model, cfg.optim, state)
    mark('optimizer')
    return logs


@torch.no_grad()
def eval_step(model: FusionOcc, state: TrainState, batch: Batch,
              use_ema: bool = True) -> torch.Tensor:
    """``predict`` with the EMA parameters (or the live ones): (B, X, Y, Z)
    uint8 class ids."""
    if not use_ema:
        return model.predict(batch)
    params = dict(model.named_parameters())
    live = {n: p.clone() for n, p in params.items()}
    try:
        for n, p in params.items():
            p.copy_(state.ema[n])
        return model.predict(batch)
    finally:
        for n, p in params.items():
            p.copy_(live[n])
