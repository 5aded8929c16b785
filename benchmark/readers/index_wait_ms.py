"""Host ms per unit blocked at the program's waits inside the pooling
index builds made in the call (span ``camera.pooling_index``), in the spans
stretch's pass without a profiler."""
from harness.spans import per_unit

NEEDS_SPANS = True      # the spans stretch (harness/spans.py)


def read(data, name):
    return per_unit(data, 'timed', 'camera.pooling_index', 'wait_ms')
