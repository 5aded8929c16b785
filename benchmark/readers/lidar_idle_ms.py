"""Device idle ms per unit while the host is inside the LiDAR encoder (the
device's gaps intersected with the span ``lidar``), in the spans
stretch's pass under the profiler (CUDA activity alone)."""
from harness.spans import per_unit

NEEDS_SPANS = True      # the spans stretch (harness/spans.py)


def read(data, name):
    return per_unit(data, 'traced', 'lidar', 'idle_ms')
