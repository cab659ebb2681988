"""The port's span log inside the traced window, for the per-layer metrics
that read it (``metrics/track_frame_ms.py``, ``metrics/pose_launches_per_call.py``).

The process Tracer (``orbslamm_tpu_torch.utils.trace.get_tracer()``) keeps one
entry for every ``stage`` and ``Tracer.span`` of the run, stamped on the clock
that ``torch.profiler`` stamps its events with, so the window's entries are
those that lie inside the ``bench.window`` range. A program that keeps no
span log gives None, and so does a log that let go of entries of the window.
"""

from __future__ import annotations


def process_log():
    """(entries, dropped) of the port's process Tracer, or None where the
    program keeps no span log."""
    from orbslamm_tpu_torch.utils.trace import get_tracer

    tr = get_tracer()
    if not hasattr(tr, "spans"):
        return None
    return tr.spans(), tr.dropped


def window_spans(tw, log=None) -> list | None:
    """The entries of ``log`` ((entries, dropped); the process Tracer's by
    default) that start and end inside the traced window ``tw``
    (``benchmark.trace.TraceWindow``); None without a window or a log, or
    where the log dropped entries that may have ended inside the window."""
    if tw is None:
        return None
    log = process_log() if log is None else log
    if log is None:
        return None
    entries, dropped = log
    # the log lets its oldest ends go first: none of the window's went if
    # the oldest end it kept lies before the window
    if dropped and (not entries or min(e.end_ns for e in entries) > tw.t0):
        return None
    return [e for e in entries if tw.t0 <= e.start_ns and e.end_ns <= tw.t1]
