"""1 - (union of the device's event intervals / the profiled stretch),
averaged over the devices the cell uses (``trace.reduce``)."""


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    busy = sum(tr["busy_s"].values()) / len(tr["busy_s"])
    if busy <= 0:
        return None
    return 1.0 - busy / tr["window_s"]
