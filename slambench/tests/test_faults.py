"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, each cell shrunk and run on the CPU
with one fault of the kinds the cell can have, planted where the answer
is produced (``slambench/core/faults.py``). A sound run of the same
shrunken cell comes out correct."""

import pytest

from slambench.core import faults
from slambench.tests.helpers import run_tiny, tiny_checkout

FAULTS = [("velodyne64.corridor", "unchanged"),
          ("velodyne64.corridor", "altered"),
          ("fleet16.shared", "unchanged"),
          ("fleet16.shared", "half_batch"),
          ("fleet16.shared", "one_agent"),
          ("fleet16.shared", "altered"),
          ("fleet16.apart", "half_batch"),
          ("fleet16.apart", "one_agent")]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("bench"))
    return tmp, tiny_checkout(tmp)


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_fault_is_caught(checkout, cell, kind):
    tmp, bench = checkout
    undo = faults.plant("single" if cell.startswith("velodyne") else "fleet",
                        kind)
    try:
        res, lines, _ = run_tiny(tmp, bench, cell, seed=11, seconds=3.0)
    finally:
        undo()
    assert res["correct"] is False, lines


@pytest.mark.parametrize("cell", ["velodyne64.corridor", "fleet16.shared",
                                  "fleet16.apart"])
def test_sound_run_is_correct(checkout, cell):
    tmp, bench = checkout
    res, lines, _ = run_tiny(tmp, bench, cell, seed=11, seconds=3.0)
    assert res["correct"] is True, lines
