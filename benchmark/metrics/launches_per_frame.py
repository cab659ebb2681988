"""Kernels the device ran in the traced window per frame handed to the
port (all streams): the launch train of the frame step."""


def read(run):
    t = run.trace
    if t is None or run.frames <= 0:
        return None
    return t.kernels() / run.frames
