"""Device ms per unit in BEVFormer-Occ's BEV encoder (``bev_encoder``: six
layers of temporal self-attention, spatial cross-attention and FFN, with
their LayerNorms), between CUDA events of forward hooks."""


def read(data, name):
    ms = data.module_ms.get('bev_encoder')
    return sum(ms) / data.clock_units if ms and data.clock_units else None
