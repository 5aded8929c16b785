"""Device ms per step between ``train_step``'s 'forward' and 'backward'
marks: the backward pass."""


def read(data, name):
    ms = data.mark_ms.get('forward-backward')
    return sum(ms) / len(ms) if ms else None
