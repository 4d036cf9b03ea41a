"""On the card: the control (the plain reference computed with TF32
matmuls in the program's place) fails a shrunken cell's limits, where
the program passes them."""

import json
import os

import pytest
import torch

from slambench.tests.helpers import BENCH_DIR, tiny_checkout

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["velodyne64.corridor", "fleet16.shared"])
def test_control_fails_where_the_program_passes(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control differs from the "
                    "reference only where TF32 matmuls exist")
    import time

    from slambench import run as R
    from slambench.core import checks
    tmp = str(tmp_path)
    bench = tiny_checkout(tmp)
    # The configuration's own sample of each agent's registrations: on
    # the card a few of a fleet's registrations end at another converged
    # solution, and the per-agent median is read over that many.
    path = os.path.join(tmp, "slambench", "configs", "fleet16.json")
    with open(path) as fh:
        cfg = json.load(fh)
    with open(os.path.join(BENCH_DIR, "configs", "fleet16.json")) as fh:
        cfg["check"]["registrations"] = json.load(fh)["check"][
            "registrations"]
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    res, lines, info = R.run_cell(bench, cell, 21, 2.0, False, root=tmp,
                                  t_start=time.perf_counter(), control=True)
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert res["correct"], lines
    assert not checks.verdict(info["control"], limits), info["control"]
