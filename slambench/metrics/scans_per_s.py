"""Scans registered per second over the whole window: every scan of every
agent in the steps completed, over the window's host seconds."""

from slambench.core import stats


def read(run):
    return stats.rate(run.scans, run.window_s)
