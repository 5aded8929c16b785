"""Checkpoints of a training run: ``torch.save`` of {step, the model's
parameters and buffers, the optimizer state, the EMA, the accumulation
buffer} in ``<root>/step_<n>/state.pt``.

Port of ``fusionocc_tpu/train/checkpoint.py``'s save, restore and
``latest_checkpoint``, and ``load_for_eval`` for the evaluation tool; the
JAX package's orbax files are not read.  Over several processes the ranks
hold the same state: rank 0 writes and every rank then meets at a barrier;
every rank reads on resume.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..parallel import mesh
from .loop import TrainState

STATE_FILE = 'state.pt'


def save_checkpoint(root: str, model: torch.nn.Module, state: TrainState
                    ) -> str:
    """Write ``<root>/step_<state.step>`` (rank 0 only; every rank of a
    process group returns once it is written); returns its path."""
    path = os.path.join(os.path.abspath(root), f'step_{state.step}')
    if mesh.rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + '.tmp')
        torch.save({'step': state.step, 'model': model.state_dict(),
                    'train_state': state.state_dict()}, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    mesh.barrier()
    return path


def restore_checkpoint(path: str, model: torch.nn.Module,
                       state: TrainState) -> None:
    """Load ``path`` (a ``step_<n>`` directory) into ``model`` and
    ``state`` in place."""
    dev = next(model.parameters()).device
    sd = torch.load(os.path.join(path, STATE_FILE), map_location=dev)
    model.load_state_dict(sd['model'], strict=True)
    state.load_state_dict(sd['train_state'])


def load_for_eval(path: str, model: torch.nn.Module, use_ema: bool = True
                  ) -> int:
    """Load a checkpoint's weights into ``model`` for evaluation: its
    parameters and buffers, then, with ``use_ema``, the EMA over the
    parameters (``tools/test.py`` evaluates ``ema_params`` unless
    ``--no-ema``).  Returns the checkpoint's step."""
    dev = next(model.parameters()).device
    sd = torch.load(os.path.join(path, STATE_FILE), map_location=dev)
    model.load_state_dict(sd['model'], strict=True)
    if use_ema:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(sd['train_state']['ema'][name])
    return int(sd['step'])


def latest_checkpoint(root: str) -> Optional[str]:
    """The ``step_<n>`` directory of ``root`` with the largest n, or
    None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith('step_'):
            try:
                steps.append((int(name.split('_')[1]), name))
            except ValueError:
                pass
    return os.path.join(root, max(steps)[1]) if steps else None
