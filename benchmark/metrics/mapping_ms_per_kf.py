"""Host milliseconds inside local mapping's ranges (``mapping.*``, their
union) per keyframe inserted in the traced window (the Tracer's
``keyframes_inserted``)."""

from benchmark.trace import union_s


def read(run):
    t = run.trace
    if t is None or run.keyframes <= 0:
        return None
    iv = t.range_iv(lambda n: n.startswith("mapping."))
    if len(iv) == 0:
        return None
    return 1e3 * union_s(iv) / run.keyframes
