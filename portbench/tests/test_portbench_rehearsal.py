"""A CPU rehearsal of each cell's control flow, judged by the plain
reference, and then the harness's modules checked for JAX and the JAX
package by top-level name."""

import sys
import time

import pytest

from portbench import run
from portbench.tests.tiny import tiny_cell

CELLS = ["restic-initial-1g"]
SEED = 2 ** 32 + 5


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(name, trace):
    cell = tiny_cell(name)
    res = run.run_cell(cell, SEED, 1.0, bool(trace), device="cpu",
                       t0=time.perf_counter())
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "breakdown" in res
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())


def test_no_jax_after_the_rehearsals():
    """Runs after the rehearsals above in this process (file order)."""
    assert "volsync_tpu_torch" in sys.modules
    assert run.forbidden_modules() == []


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
