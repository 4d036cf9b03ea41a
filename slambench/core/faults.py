"""Faults planted in the program's timed path, for the tests and readings
that show a broken run comes out not correct (``slambench/tests/
test_faults.py`` on the CPU, ``slambench/control.py --fault`` on the
card). Never planted in a benchmark run.

Each breaks the registrations where they are produced: the driver's
entry (``single``: the localizer's ``icp_core``; ``fleet``: the fleet's
``batched_register``) returns transforms that are

* ``unchanged``: the starting transforms (a step that leaves its state);
* ``half_batch``: the starting transforms in the batch's second half;
* ``one_agent``: the starting transform of one agent of the batch;
* ``altered``: moved ``ALTER_M`` along x;

and ``closure_altered`` breaks the loop closer's verifications where
they are produced (every registration route of
``pgslam_tpu_torch/loopcloser.py``): each closure's transform moved
``ALTER_M`` along x, for any driver.
"""

from __future__ import annotations

import dataclasses

ALTER_M = 0.05
KINDS = ("unchanged", "half_batch", "one_agent", "altered")
CLOSURE_ROUTES = ("register_one", "icp_core", "batched_register")


def registration_fault(kind: str, agent: int = 1):
    """Wrap a registration function (one transform, or a batch) so that
    its answer is broken by ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")

    def wrap(orig):
        def broken(reading, reference, T0, cfg, *a, **kw):
            res = orig(reading, reference, T0, cfg, *a, **kw)
            T = res.T.clone()
            start = T0.to(T.dtype)
            if kind == "unchanged":
                T = start.clone()
            elif kind == "half_batch":
                half = T.shape[0] // 2
                T[half:] = start[half:]
            elif kind == "one_agent":
                T[agent] = start[agent]
            else:
                T[..., 0, 3] += ALTER_M
            return dataclasses.replace(res, T=T)
        return broken
    return wrap


def plant(entry: str, kind: str):
    """Plant ``kind`` under the driver ``entry``; returns the undo."""
    if kind == "closure_altered":
        from pgslam_tpu_torch import loopcloser as mod
        names, kind = CLOSURE_ROUTES, "altered"
    elif entry == "single":
        from pgslam_tpu_torch import localizer as mod
        names = ("icp_core",)
    elif entry == "fleet":
        from pgslam_tpu_torch.parallel import multi_agent as mod
        names = ("batched_register",)
    else:
        raise ValueError(f"no fault for the driver {entry!r}")
    orig = {name: getattr(mod, name) for name in names}
    for name, fn in orig.items():
        setattr(mod, name, registration_fault(kind)(fn))

    def undo():
        for name, fn in orig.items():
            setattr(mod, name, fn)
    return undo
