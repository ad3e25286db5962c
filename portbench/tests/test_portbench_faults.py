"""A run with its timed path broken underneath comes out not correct:
once for each fault a cell can have, and for the control. The chip's
look is skipped (``device="cpu"``) and the cells are cut to a CPU size."""

import time

import pytest

from portbench import run
from portbench.tests.faults import plant
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 32 + 9
CASES = [(cell, fault) for cell in ("restic-initial-1g",)
         for fault in ("unchanged", "half", "altered", "control")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    plant(monkeypatch, cell, fault)
    res = run.run_cell(cell, SEED, 1.0, False, device="cpu",
                       t0=time.perf_counter())
    assert res["correct"] is False, res["compared"]
    # found by the comparison, not by a window that finished nothing
    assert res["compared"]["requests_done_short"]["value"] == 0
