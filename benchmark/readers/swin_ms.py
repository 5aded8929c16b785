"""Device ms per unit in the camera backbone (``img_backbone``, Swin-B),
between CUDA events of forward hooks."""


def read(data, name):
    ms = data.module_ms.get('img_backbone')
    return sum(ms) / data.clock_units if ms and data.clock_units else None
