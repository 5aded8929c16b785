"""Device ms per unit in the LiDAR encoder (``lidar_encoder``), between
CUDA events of forward hooks."""


def read(data, name):
    ms = data.module_ms.get('lidar_encoder')
    return sum(ms) / data.clock_units if ms and data.clock_units else None
