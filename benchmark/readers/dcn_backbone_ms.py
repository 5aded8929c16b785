"""Device ms per unit in BEVFormer-Occ's camera backbone (``img_backbone``:
ResNet-101 with its 26 DCNv2 convs), between CUDA events of forward
hooks."""


def read(data, name):
    ms = data.module_ms.get('img_backbone')
    return sum(ms) / data.clock_units if ms and data.clock_units else None
