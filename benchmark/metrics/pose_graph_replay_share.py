"""Share of the traced window's pose solves that replayed a CUDA graph: the
span log's ``ba.pose_optimize`` entries in the window whose ``graph``
attribute is "replay", over all of them, in %. None where the log dropped
entries of the window, where it holds no solve, or where no solve says how
it ran (a program without the pose solve's graphs)."""

from benchmark.spans import window_spans


def read(run, log=None):
    spans = window_spans(run.trace, log)
    if spans is None:
        return None
    modes = [e.attrs.get("graph") for e in spans if e.name == "ba.pose_optimize"]
    if not any(m is not None for m in modes):
        return None
    return 100.0 * sum(m == "replay" for m in modes) / len(modes)
