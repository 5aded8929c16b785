"""Device ms per step between ``train_step``'s 'backward' and 'optimizer'
marks: clipping, AdamW and the EMA."""


def read(data, name):
    ms = data.mark_ms.get('backward-optimizer')
    return sum(ms) / len(ms) if ms else None
