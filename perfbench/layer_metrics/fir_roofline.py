"""``fir_roofline`` (%): the least time the chip could take for the
calls' work (``roofline.CallWork``: the larger of its bytes over the
memory bandwidth and its operations over the highest dense rate) over
the device time of the port's own kernels in the traced calls."""


def read(view):
    kernel_s = view.op_seconds(port=True)
    if view.peaks is None or not view.calls or kernel_s <= 0:
        return None
    return 100.0 * view.work.least_s(view.peaks) * view.calls / kernel_s
