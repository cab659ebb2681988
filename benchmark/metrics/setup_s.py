"""Seconds from the process's start to the window: imports, the kernels'
build, rendering the streams, the session, initialization and the warm-up."""


def read(run):
    return run.setup_s
