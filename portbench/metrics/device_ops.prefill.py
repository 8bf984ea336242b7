"""Device operations (kernels, copies, sets) a traced prefill."""


def read(cell, out):
    tr = out.trace
    if tr is None or not tr.on_card or not tr.device:
        return None
    return len(tr.device) / tr.calls
