"""K2, the window attention (``fusionocc::window_attn``): share (%) of its
roofline."""
from harness.peaks import roofline_share

NEEDS_OP_CALLS = True      # the profiled units replayed under OpRecorder


def read(data, name):
    return roofline_share(data, ['window_attn'])
