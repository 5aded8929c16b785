"""Device ms per unit in the trunk and head (the program's span ``head``:
the BEV trunk, the final conv and the predicter), between its CUDA events,
in the spans stretch's pass without a profiler."""
from harness.spans import per_unit

NEEDS_SPANS = True      # the spans stretch (harness/spans.py)


def read(data, name):
    return per_unit(data, 'timed', 'head', 'device_ms')
