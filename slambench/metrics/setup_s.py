"""Seconds from the process's start to the window's: imports, device
start, the kernels' build or load, rendering the traffic, the warm-up."""


def read(run):
    return run.setup_s
