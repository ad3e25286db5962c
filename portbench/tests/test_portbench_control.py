"""The control of each cell at the cell's own size, on the card: it has to
come out not correct, on three seeds. The benchmark's runs never plant it;
this test does, around ``run.run_cell`` (``faults.py`` says what each
control breaks; ``test_portbench_faults.py`` plants the faults on the
CPU). It skips where no CUDA card is present.

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda -s

prints every run's compared numbers (``control ...`` lines) and writes
them to ``$PORTBENCH_CONTROL_OUT`` when that is set.
"""

import json
import os
import time

import pytest

from portbench import run, spec
from portbench.tests.faults import plant

SEEDS = (7_000_000_001, 7_000_000_002, 7_000_000_003)
WINDOW_S = 10.0
CELLS = ("restic-initial-1g",)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, monkeypatch, name, seed):
    cell = spec.load_cell(name)
    plant(monkeypatch, cell, "control")
    res = run.run_cell(cell, seed, WINDOW_S, False,
                       t0=time.perf_counter())
    line = {"cell": name, "seed": seed,
            "correct": res["correct"], "attempted": res["attempted"],
            "compared": res["compared"]}
    print("control", json.dumps(line), flush=True)
    out = os.environ.get("PORTBENCH_CONTROL_OUT")
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    assert res["correct"] is False
