"""The plane sweep's share (%) of its roofline: the frozen bound of the
unit's cost volumes over the device time the ``cost_volume`` clock read
(``cost_volume_ms``).

One volume of BN = cameras x batch images, D depth planes, h x w = the
input over 4 and C stage-0 channels needs, by the frozen formula,
10·C·BN·D·h·w FLOPs in float32 (per hypothesis and channel a bilinear
sample's 4 multiplies and 3 adds, a difference, an absolute value and an
add) and 4·(2·BN·h·w·C + BN·D·h·w) bytes (both features read, the volume
written, float32); its bound is the larger of the FLOPs over 67 TFLOP/s
and the bytes over 3.35 TB/s.  The shapes come from the configuration
file of the cell this metric's entry names; each clocked call is one
volume.  None where no cost volume was clocked (a model without one)."""
import torch

from harness import spec
from harness.peaks import PEAK_BYTES, PEAK_FLOPS


def volume(model: dict, batch_size: int):
    """(FLOPs, bytes) of one volume at the configuration's shapes."""
    lo, hi, step = model['grid']['depth']
    D = int(round((hi - lo) / step))
    H, W = model['input_size']
    h, w = H // 4, W // 4
    BN = model['num_cams'] * batch_size
    C = model['swin']['embed_dims']
    return 10 * C * BN * D * h * w, 4 * (2 * BN * h * w * C + BN * D * h * w)


def read(data, name):
    ms = data.module_ms.get('cost_volume')
    if not ms or sum(ms) <= 0:
        return None
    bench = spec.load_benchmark()
    entry = next(m for m in bench['per_layer'] if m['name'] == name)
    cell = spec.cell(bench, entry['workloads'][0])
    conf = spec.load_json(spec.ROOT,
                          spec.config_entry(bench, cell['config'])['file'])
    flops, nbytes = volume(conf['model'], conf['batch_size'])
    bound_ms = 1e3 * max(flops / PEAK_FLOPS[torch.float32],
                            nbytes / PEAK_BYTES)
    return 100.0 * bound_ms * len(ms) / sum(ms)
