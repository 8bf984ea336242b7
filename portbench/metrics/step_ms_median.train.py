"""Median host time of a train step in the window, in ms (each step
ends with its loss on the host), the steps the profiler ran left out."""

import statistics


def read(cell, out):
    calls = out.untraced_s()
    return statistics.median(calls) * 1e3 if calls else None
