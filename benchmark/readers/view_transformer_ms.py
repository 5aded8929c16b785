"""Device ms per unit in the view transformer (the program's span
``camera.view_transformer``, K1's pooling in it, summed over the unit's
camera passes), between its CUDA events, in the spans stretch's pass
without a profiler."""
from harness.spans import per_unit

NEEDS_SPANS = True      # the spans stretch (harness/spans.py)


def read(data, name):
    return per_unit(data, 'timed', 'camera.view_transformer', 'device_ms')
