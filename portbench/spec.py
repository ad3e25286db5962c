"""Finds each piece of a cell by its name: the cell, its configuration and
traffic mix from ``BENCHMARK.json`` and ``portbench/configs/``,
``portbench/traffic/``; the load that a mix names by its ``kind`` in
``portbench/loads/``; each metric's reader in ``portbench/metrics/``
(``x.sync`` in ``x.sync.py``, or else ``x.py``) and each kernel family
in ``portbench/kernels/``. A new cell, mix, metric or kernel family is
new files and entries, never an edit."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set | None) -> bool:
    """A metric with ``workloads`` is reported in those cells; an
    end-to-end one without it in every cell, a per-layer one in every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: Path | None = None,
              root: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark file (``BENCHMARK.json`` beside
    the ``portbench`` folder by default)."""
    spec = _load_json(bench or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the benchmark")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(root.parent / cfg_entry["file"])
    traffic = _load_json(root / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module or, where there is no such
    file, the file of the name before its first dot, so that one reader
    serves ``x.sync`` and ``x.service``. A name that is an identifier in
    the installed benchmark imports as ``portbench.<kind>.<name>`` (one
    module object for everyone); names with dots or dashes load from
    their file."""
    path = root / kind / f"{name}.py"
    if not path.exists() and "." in name:
        name = name.split(".")[0]
        path = root / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} named {name!r} ({path})")
    if root == HERE and name.isidentifier():
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
