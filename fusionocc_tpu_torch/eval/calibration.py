"""Confidence calibration: temperature scaling and uncertainty maps.

Port of ``fusionocc_tpu/eval/calibration.py`` (the reference's
fusion_occ.py:1497-1602, tools/export_occ_logits.py,
tools/train_temperature.py): export per-voxel logits, fit a scalar
temperature by the NLL on masked voxels, apply it at inference, and derive
MSP and entropy uncertainty maps.  The NLL is evaluated on the logits'
device in float32; the golden-section search runs on the host in float64,
as JAX's does.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def nll_at_temperature(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor], temperature: float
                       ) -> torch.Tensor:
    """Mean masked NLL of temperature-scaled logits (a float32 scalar)."""
    logp = torch.log_softmax(logits.float() / temperature, dim=-1)
    flat_lp = logp.reshape(-1, logits.shape[-1])
    flat_lbl = labels.reshape(-1).long()
    nll = -flat_lp.gather(1, flat_lbl[:, None])[:, 0]
    if mask is not None:
        w = mask.reshape(-1).float()
        return (nll * w).sum() / w.sum().clamp_min(1.0)
    return nll.mean()


def golden_section(f, lo: float, hi: float, iters: int = 60) -> float:
    """The minimiser of ``f`` over log-space [log lo, log hi] by
    golden-section search (``iters`` steps), returned as exp of the final
    interval's midpoint; JAX's search, step for step."""
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(lo), np.log(hi)
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = f(np.exp(c)), f(np.exp(d))
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = f(np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = f(np.exp(d))
    return float(np.exp((a + b) / 2.0))


def fit_temperature(logits, labels, mask=None, lo: float = 0.05,
                    hi: float = 10.0, iters: int = 60) -> float:
    """Scalar temperature minimising the masked NLL, by golden-section
    search over log-temperature (the objective is unimodal there).  Each
    step evaluates the float32 NLL where ``logits`` is (on the card for
    a CUDA tensor).  Near the minimum the search's
    comparisons fall below the float32 NLL's resolution, so two
    implementations that sum in another order stop about 1e-4 apart (in
    relative temperature) with NLLs equal to float32 precision."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device)
    mask = (None if mask is None
            else torch.as_tensor(mask, device=logits.device))
    return golden_section(
        lambda t: float(nll_at_temperature(logits, labels, mask, float(t))),
        lo, hi, iters)


def apply_temperature(logits: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    """Scaled probabilities, float32."""
    return torch.softmax(logits.float() / temperature, dim=-1)


def uncertainty_maps(logits: torch.Tensor,
                     temperature: float = 1.0) -> Dict[str, torch.Tensor]:
    """Probabilities, MSP, entropy normalised by log(num_classes) and the
    uint8 argmax."""
    probs = apply_temperature(logits, temperature)
    msp = probs.max(dim=-1).values
    p = probs.clamp(1e-12, 1.0)
    ent = -(p * torch.log(p)).sum(dim=-1) / np.log(logits.shape[-1])
    return {'probs': probs, 'msp': msp, 'entropy': ent,
            'pred': probs.argmax(dim=-1).to(torch.uint8)}


def export_logits(model, batch) -> Dict[str, np.ndarray]:
    """Dense logits (float16) with the GT and camera mask of ``batch``, for
    an offline temperature fit; the model runs with eval semantics."""
    with torch.inference_mode(), model.eval_semantics():
        out = model(batch)
    return {
        'logits': out['occ_logits'].cpu().numpy().astype(np.float16),
        'voxel_semantics': batch.voxel_semantics.cpu().numpy(),
        'mask_camera': batch.mask_camera.cpu().numpy(),
    }
