"""The numbers that decide ``correct``, each held to its limit.

Served occupancy (the stream and two-pass cells), against the reference's
float32 logits: ``gap_mean`` and ``gap_max``, the mean and the widest gap
by which the logit of the program's class lies below the reference's best,
over the reference's spread of logits between classes (the mean over
voxels of their standard deviation); where the path returns its logits,
``logit_rel_l2``, the distance of the program's logits from the
reference's over the norm of the reference's.  How far a seed's network
carries bfloat16's rounding differs from seed to seed, so the numbers
compared are how far these exceed the same of the reference computed in
the configuration's precision (``gap_excess``, ``logit_excess``: the ratio
of the two, less 1): about 0 for a sound bfloat16 program on every seed,
and above 1 where a step loses precision beyond bfloat16's own rounding
(the port's int8 serving path).  Training: ``loss_gap``, the relative gap of the first step's
loss; ``change_gap``, the median leaf's relative gap between the
program's and the reference's norms of the parameters' change over three
steps (read only: the worst leaf's, over the larger of the reference's
norm of that leaf and of the median leaf, and the same of the first
gradient as the optimizer took it, clipped); leaves whose reference
gradient is under a thousandth of the median leaf's are left out.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Number = Tuple[str, float, float]       # name, value, limit


def logit_gaps(pred: torch.Tensor, ref_logits: torch.Tensor
               ) -> Dict[str, float]:
    """pred (..., ) class ids; ref_logits (..., ncls) float32."""
    r = ref_logits.float()
    scale = r.std(dim=-1).mean()
    gap = r.amax(-1) - r.gather(-1, pred.long()[..., None])[..., 0]
    return {'gap_max': float(gap.max() / scale),
            'gap_mean': float(gap.mean() / scale)}


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.float() - ref.float()).norm() / ref.float().norm())


FLOOR = 1e-6    # the ratios' least denominator (a float32 configuration's)


def served(kept: Dict[int, tuple], r32: Dict[int, torch.Tensor],
           r16: Dict[int, torch.Tensor]) -> Dict[str, float]:
    """The numbers of the frames in ``kept`` ({t: (class ids, logits or
    None)}) against the float32 reference's logits ``r32``, and the same
    of the reference in the configuration's precision ``r16``."""
    out = {'gap_mean': 0.0, 'gap_max': 0.0, 'gap_mean_floor': 0.0}
    d = {'p': 0.0, 'floor': 0.0, 'ref': 0.0}
    for t, (pred, logits) in kept.items():
        g = logit_gaps(pred, r32[t])
        f = logit_gaps(r16[t].argmax(-1), r32[t])
        out['gap_mean'] += g['gap_mean'] / len(kept)
        out['gap_mean_floor'] += f['gap_mean'] / len(kept)
        out['gap_max'] = max(out['gap_max'], g['gap_max'])
        if logits is not None:
            d['p'] += float((logits.float() - r32[t]).square().sum())
            d['floor'] += float((r16[t].float() - r32[t]).square().sum())
            d['ref'] += float(r32[t].square().sum())
    out['gap_ratio'] = out['gap_mean'] / max(out['gap_mean_floor'], FLOOR)
    out['gap_excess'] = out['gap_ratio'] - 1
    if d['ref']:
        out['logit_rel_l2'] = (d['p'] / d['ref']) ** 0.5
        out['logit_rel_l2_floor'] = (d['floor'] / d['ref']) ** 0.5
        out['logit_ratio'] = out['logit_rel_l2'] / max(
            out['logit_rel_l2_floor'], FLOOR)
        out['logit_excess'] = out['logit_ratio'] - 1
    return out


def reference_outputs(drv, count: bool = False):
    """The sampled units' logits from the float32 reference (with the FLOPs
    of one unit when ``count``) and from the reference in the
    configuration's precision, each model built, run and freed in turn."""
    from . import program
    ctx = drv.ctx
    dtype = program.port_config(ctx.conf).model.compute_dtype
    outs = []
    for prec in (None, dtype):
        _, ref = program.reference_model(ctx.conf, ctx.seed, ctx.device, prec)
        outs.append(drv.reference_outputs(ref, count and prec is None))
        del ref
        if ctx.cuda:
            torch.cuda.empty_cache()
    (r32, flops), (r16, _) = outs
    return r32, r16, flops


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    """Worst leaf of |prog - ref| / max(ref, median ref) over ``keep``."""
    vals = torch.tensor([ref[k] for k in keep], dtype=torch.float64)
    med = float(vals.median())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: List[str]) -> float:
    """The median leaf's |prog - ref| / ref over ``keep``."""
    return float(torch.tensor([abs(prog[k] - ref[k]) / ref[k] for k in keep],
                              dtype=torch.float64).median())


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(torch.tensor(list(ref_grad.values()),
                             dtype=torch.float64).median())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def held(numbers: List[Number]) -> bool:
    return all(v == v and v <= lim for _, v, lim in numbers)
