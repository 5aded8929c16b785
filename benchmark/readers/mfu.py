"""Model FLOP utilisation (%): the FLOPs of one unit counted on the plain
reference (``reference/counting.py``) times the units of the window's
uninstrumented stretch, over its seconds and the card's bf16 peak."""
from harness.peaks import PEAK_BF16


def read(data, name):
    if not data.ref_flops_per_unit or data.plain_wall_s <= 0:
        return None
    return (100.0 * data.ref_flops_per_unit * data.plain_units
            / data.plain_wall_s / PEAK_BF16)
