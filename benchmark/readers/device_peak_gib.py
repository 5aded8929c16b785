"""Peak device memory allocated during the window (GiB), after the peak
was reset at its start."""


def read(data, name):
    return data.window_peak_bytes / 2 ** 30 if data.window_peak_bytes else None
