"""``step_mfu`` (%): the whole step's share of the chip's highest dense
rate: the traced calls' operations (two a tap of each output sample)
over the traced sub-window's length times that rate."""


def read(view):
    window = view.window_s
    if view.peaks is None or not view.calls or window <= 0:
        return None
    return (100.0 * view.work.ops * view.calls
            / (window * view.peaks["dense_ops_s"]))
