"""The deformable sampling's share (%) of its roofline: the frozen bounds
of the unit's ``ms_deform_attn`` calls (the clocks ``msda.tsa.<i>`` and
``msda.sca.<i>``) over the device time those clocks read.

One call of Q query rows, H heads of d channels, L levels and P points
needs, by the frozen formula, 10·Q·H·L·P·d FLOPs (per channel the 4
bilinear taps' multiplies and adds, the weight's multiply and the sum's
add) and reads the value once, the float32 locations and weights, and
writes the output once; its bound is the larger of the FLOPs over the
peak of the configuration's compute dtype and the bytes over 3.35 TB/s.
Temporal self-attention: Q = 2 x the BEV cells (the previous and the
current frame), L = 1, P = ``tsa_points``, the value the two BEV frames.
Spatial cross-attention: Q = the (query, camera) pairs the cell's rig sees
(a query's anchor inside a camera's image: ``reference.bevformer_occ.
point_sampling`` on ``harness.inputs``' rig), L = ``num_levels``, P =
``sca_points``, the value every camera's levels.  The shapes come from the
configuration file of the cell this metric's entry names; a padded
re-batch reads below 100 %.  None where no sampling was clocked."""
import torch

from harness import inputs, program, spec
from harness.peaks import PEAK_BYTES, PEAK_FLOPS


def seen_pairs(conf: dict) -> int:
    """The (query, camera) pairs one sample's rig sees."""
    from reference.bevformer_occ import BEVFormerConfig, point_sampling
    cfg = program.reference_config(conf).model
    bev = spec.build_dataclass(BEVFormerConfig, conf['bevformer'])
    N = cfg.num_cams
    eye = torch.eye(3).expand(1, N, 3, 3)
    _, mask = point_sampling(
        cfg, bev, inputs.camera_rig(N, 'cpu')[None],
        inputs.intrinsics(cfg.input_size, 'cpu').expand(1, N, 3, 3), eye,
        torch.zeros(1, N, 3))
    return int(mask.any(-1).sum())


def calls(conf: dict):
    """{'tsa': (FLOPs, bytes), 'sca': (FLOPs, bytes)} of one call each and
    the compute dtype."""
    m, b = conf['model'], conf['bevformer']
    B = conf['batch_size']
    dtype = getattr(torch, m['compute_dtype'])
    e = torch.empty((), dtype=dtype).element_size()
    grid = program.reference_config(conf).model.grid
    cells = grid.size_x * grid.size_y
    C, H = b['embed_dims'], b['num_heads']
    d = C // H
    S = sum(h * w for h, w in _levels(conf))
    out = {}
    for kind, q, L, P, value in (
            ('tsa', 2 * B * cells, 1, b['tsa_points'], 2 * B * cells),
            ('sca', B * seen_pairs(conf), b['num_levels'], b['sca_points'],
             B * m['num_cams'] * S)):
        n = q * H * L * P
        out[kind] = (10 * n * d, value * C * e + n * 3 * 4 + q * C * e)
    return out, dtype


def _levels(conf: dict):
    """The FPN levels' (h, w) of the padded input."""
    pad = conf['bevformer']['pad_divisor']
    h, w = (-(-s // pad) * pad for s in conf['model']['input_size'])
    out = []
    first = 1 + conf['bevformer']['out_indices'][0]
    for i in range(first + conf['bevformer']['num_levels']):
        h, w = -(-h // 2), -(-w // 2)
        if i >= first:
            out.append((h, w))
    return out


def read(data, name):
    ms = {k: v for k, v in data.module_ms.items() if k.startswith('msda.')}
    total = sum(sum(v) for v in ms.values())
    if not ms or total <= 0:
        return None
    bench = spec.load_benchmark()
    entry = next(m for m in bench['per_layer'] if m['name'] == name)
    cell = spec.cell(bench, entry['workloads'][0])
    conf = spec.load_json(spec.ROOT,
                          spec.config_entry(bench, cell['config'])['file'])
    per, dtype = calls(conf)
    bound_ms = sum(len(v) * 1e3 * max(per[k.split('.')[1]][0]
                                      / PEAK_FLOPS[dtype],
                                      per[k.split('.')[1]][1] / PEAK_BYTES)
                   for k, v in ms.items())
    return 100.0 * bound_ms / total
