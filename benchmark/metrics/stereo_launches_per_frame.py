"""Device operations (kernels, copies and fills) the stereo association puts
on the device: those of the traced window that start on the device inside
one of its ``stereo.match`` or ``stereo.refine`` ranges, over the window's
frames. Counted as ``pose_launches_per_call`` counts a solve's: an
operation that waits behind earlier work and starts after its range has
closed is not counted."""

import numpy as np

STAGES = ("stereo.match", "stereo.refine")


def read(run):
    t = run.trace
    if t is None or not run.frames or not len(t.dev_iv):
        return None
    iv = t.range_iv(lambda n: n in STAGES)
    if len(iv) == 0:
        return None
    starts = np.sort(t.dev_iv[:, 0])
    inside = np.searchsorted(starts, iv[:, 1], side="right") - np.searchsorted(
        starts, iv[:, 0], side="right")
    return float(inside.sum()) / run.frames
