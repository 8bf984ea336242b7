"""Model FLOPs (`yardstick`) of the window's prefills over their host
time, as a share of one H100's dense bf16 peak, in %: the whole call's
share of the card's peak, which bounds every kernel's roofline.  The
prefills the profiler ran are left out, since its host cost slows them;
read in the traced run, from the window's clock."""

from portbench.yardstick import PEAK_BF16_FLOPS


def read(cell, out):
    calls = out.untraced_s()
    if out.trace is None or not out.trace.on_card or not calls:
        return None
    rate = out.flops_per_call * len(calls) / sum(calls)
    return 100.0 * rate / PEAK_BF16_FLOPS
