"""Share of the traced window's host time inside ``ba.pose_optimize``
(the motion-only BA's ranges, their union), in %."""

from benchmark.trace import union_s


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    iv = t.range_iv(lambda n: n == "ba.pose_optimize")
    if len(iv) == 0:
        return None
    return 100.0 * union_s(iv) / t.window_s
