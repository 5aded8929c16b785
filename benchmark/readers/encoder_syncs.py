"""Host synchronisations per unit made inside the LiDAR encoder
(``torch.cuda.set_sync_debug_mode('warn')``)."""


def read(data, name):
    if not data.sync_units or 'lidar_encoder' not in data.module_ms:
        return None
    return data.syncs.get('lidar_encoder', 0) / data.sync_units
