"""``step.other_ms`` (ms): the device time a call of everything that is
not a port kernel: the step's PyTorch operations (the zero-tail
concatenation, the next history's copy, any other copy or fill)."""


def read(view):
    if not view.calls or not view.device:
        return None
    return 1e3 * view.op_seconds(port=False) / view.calls
