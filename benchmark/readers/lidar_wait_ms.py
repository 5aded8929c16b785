"""Host ms per unit blocked at the program's waits inside the LiDAR
encoder (``profiling.wait`` sites inside the span ``lidar``), in the
spans stretch's pass without a profiler."""
from harness.spans import per_unit

NEEDS_SPANS = True      # the spans stretch (harness/spans.py)


def read(data, name):
    return per_unit(data, 'timed', 'lidar', 'wait_ms')
