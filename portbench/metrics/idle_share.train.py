"""Share of the traced window in which no operation ran on the card,
in % (1 - union of the device intervals / window)."""


def read(cell, out):
    tr = out.trace
    if tr is None or not tr.on_card or tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
