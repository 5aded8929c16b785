"""Device ms per unit in the plane sweep (the port's ``cost_volume``
module: the grouped bilinear samples, the matching cost, the invalid bias
and the softmax over depth), between CUDA events of forward hooks."""


def read(data, name):
    ms = data.module_ms.get('cost_volume')
    return sum(ms) / data.clock_units if ms and data.clock_units else None
