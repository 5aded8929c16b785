"""FLOPs of the reference, counted as a yardstick.

``count_flops(run)`` runs ``run()`` under ``FlopCounterMode``, which counts
aten's matmuls and convolutions (2 per multiply-add), the window
attention's einsums among them.  The pooling and the sparse conv go
through ``kernel_call``: while counting, their plain implementation runs
outside the counting mode and adds its frozen formula instead (its
``flops()``; twice that again for the backward, the gradients of both
operands), so the count is of the work the operation needs, not of how
the plain version happens to compute it.
"""
from __future__ import annotations

import contextvars
from typing import Callable

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

_EXTRA = contextvars.ContextVar('extra_flops', default=None)


class _Counted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, flops, *inputs):
        # the backward runs on autograd's thread, where the context
        # variable is unset: it adds to the box the forward saw
        ctx.fn, ctx.flops, ctx.extra = fn, flops, _EXTRA.get()
        ctx.save_for_backward(*inputs)
        with _disable_current_modes():
            out = fn(*inputs)
        ctx.extra[0] += flops
        return out

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(t.is_floating_point())
                  for t in ctx.saved_tensors]
        with _disable_current_modes(), torch.enable_grad():
            out = ctx.fn(*inputs)
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        ctx.extra[0] += 2 * ctx.flops
        return (None, None) + tuple(next(grads) if t.requires_grad else None
                                    for t in inputs)


def kernel_call(fn: Callable, flops: Callable[[], int], *inputs):
    """``fn(*inputs)``; while ``count_flops`` runs, counted by ``flops()``."""
    if _EXTRA.get() is None:
        return fn(*inputs)
    return _Counted.apply(fn, flops(), *inputs)


def count_flops(run: Callable) -> int:
    extra = [0]
    token = _EXTRA.set(extra)
    try:
        with FlopCounterMode(display=False) as counter:
            run()
    finally:
        _EXTRA.reset(token)
    return int(counter.get_total_flops()) + extra[0]
