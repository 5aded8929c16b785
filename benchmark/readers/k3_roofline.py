"""K3, the zwin sparse conv (``fusionocc::zwin_conv`` and
``fusionocc::zwin_conv_epi``): share (%) of its roofline."""
from harness.peaks import roofline_share

NEEDS_OP_CALLS = True      # the profiled units replayed under OpRecorder


def read(data, name):
    return roofline_share(data, ['zwin_conv', 'zwin_conv_epi'])
