"""BENCHMARK.json against the benchmark's contract, and every piece that it
names found by name; a throwaway cell, mix, metric and kernel family added
by new files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w)
                                                for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_full_check_fits_its_day():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        held = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(held["reduced"])


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS and "layer" not in m
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert callable(spec.load_module("metrics", m["name"]).read)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    c = spec.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    spec.load_module("loads", c.traffic["kind"])
    for m in c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_a_cell_mix_metric_and_kernel_family_come_from_new_files(tmp_path):
    """Copy the benchmark, add a cell, a mix, a per-layer metric and a
    kernel family as new files and entries only, and find them all."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "portbench" / "traffic" / "restic-tiny-warm.json").write_text(
        json.dumps({**json.loads((ROOT / "portbench" / "traffic" /
                                  "restic-initial.json").read_text()),
                    "check_syncs": 1}))
    (tmp_path / "portbench" / "metrics" / "throwaway_count.sync.py"
     ).write_text("def read(run):\n    return len(run.inputs['x'])\n")
    (tmp_path / "portbench" / "kernels" / "throwaway.py").write_text(
        "KERNELS = ('throwaway_kernel',)\n\n\ndef work(lengths):\n"
        "    return sum(lengths), sum(lengths)\n")
    bench["workloads"].append({"name": "restic-tiny-warm-1g",
                               "config": "restic-pvc-1g",
                               "traffic": "restic-tiny-warm", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "throwaway_count.sync", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "repo", "moves": "sync_bytes_ratio",
                               "workloads": ["restic-tiny-warm-1g"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root = tmp_path / "portbench"
    cell = spec.load_cell("restic-tiny-warm-1g", root=root)
    assert cell.traffic["check_syncs"] == 1
    assert "throwaway_count.sync" in {m["name"] for m in cell.per_layer}
    reader = spec.load_module("metrics", "throwaway_count.sync", root=root)
    assert reader.read(type("R", (), {"inputs": {"x": [1, 2]}})) == 2
    fam = spec.load_module("kernels", "throwaway", root=root)
    assert fam.work([3, 4]) == (7, 7)
    after = {p: p.read_bytes() for p in before}
    assert after == before
