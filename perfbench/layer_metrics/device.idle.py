"""``device.idle`` (%): the share of the traced sub-window in which no
operation ran on the device: 1 - (union of the device's operation
intervals) / (the sub-window's length)."""


def read(view):
    window = view.window_s
    if window <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / window)
