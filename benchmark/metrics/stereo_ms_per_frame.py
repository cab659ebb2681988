"""Host milliseconds a frame in the stereo association: the union of the
traced window's ``stereo.match`` and ``stereo.refine`` ranges, over the
window's frames."""

from benchmark.trace import union_s

STAGES = ("stereo.match", "stereo.refine")


def read(run):
    t = run.trace
    if t is None or not run.frames:
        return None
    iv = t.range_iv(lambda n: n in STAGES)
    if len(iv) == 0:
        return None
    return 1e3 * union_s(iv) / run.frames
