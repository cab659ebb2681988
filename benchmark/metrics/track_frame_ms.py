"""Median host milliseconds of a tracking-only frame: the span log's
``frame`` entries in the traced window (one a call of the tracker's
per-frame entry) that inserted no keyframe (``kf`` false) and ended
tracking (``state`` OK). ORB-SLAM2's examples print the median tracking
time a frame; this is that number for the frames that only track."""

import statistics

from benchmark.spans import window_spans


def read(run, log=None):
    spans = window_spans(run.trace, log)
    if spans is None:
        return None
    ms = [(e.end_ns - e.start_ns) / 1e6 for e in spans
          if e.name == "frame" and e.attrs.get("kf") is False and e.attrs.get("state") == "OK"]
    return statistics.median(ms) if ms else None
