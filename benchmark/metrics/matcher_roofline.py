"""The matcher kernels' share of their roofline, in %: the least time of
the window's matcher calls (``peaks.matcher_least_s`` of each call's mode
and shape, from the port's ``launches_by_shape``) over the device time of
the matcher's kernels (``hamming_*``) in the traced window."""

from benchmark.peaks import matcher_least_s


def read(run):
    t = run.trace
    if t is None or not run.matcher_calls:
        return None
    busy = t.device_seconds(lambda n: "hamming_" in n)
    if busy <= 0:
        return None
    least = sum(c * matcher_least_s(mode, n, m) for (mode, n, m), c in run.matcher_calls.items())
    return 100.0 * least / busy
