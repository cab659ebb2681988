"""Frames a second per stream over the whole window: every frame handed to
the port in the window, tracked or not, over the window's host-clock
seconds (first work handed to the last answer back) and the streams."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.frames / run.window_s / run.streams
