"""Device operations (kernels, copies and fills) a pose solve puts on the
device: those of the traced window that start on the device inside one of
the span log's ``ba.pose_optimize`` entries in the window, over those
entries. The device is idle most of the window (``device_idle_share``), so
an operation starts within microseconds of its launch and the count is the
solve's launch train; a CUDA graph's kernels count one by one."""

import numpy as np

from benchmark.spans import window_spans


def read(run, log=None):
    t = run.trace
    spans = window_spans(t, log)
    if not spans or not len(t.dev_iv):
        return None
    iv = np.array([[e.start_ns, e.end_ns] for e in spans if e.name == "ba.pose_optimize"],
                  np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return None
    starts = np.sort(t.dev_iv[:, 0])
    inside = np.searchsorted(starts, iv[:, 1], side="right") - np.searchsorted(
        starts, iv[:, 0], side="right")
    return float(inside.sum()) / len(iv)
