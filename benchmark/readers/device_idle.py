"""Share (%) of the profiled units' wall in which no operation ran on the
device: 1 - the union of the device's operation intervals over the wall."""


def read(data, name):
    if data.profile_wall_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.profile_wall_s)
