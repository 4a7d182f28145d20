"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is ``configs/<name>.json`` (the manifest's ``file``),
the mix's ``traffic/<traffic>.json``, and each per-layer metric's reader
``metrics/<metric>.py``. The configuration's top-level ``family`` names
its model family, ``harness/families/<family>.py`` (with the plain model
in ``reference/<family>.py``); the mix's ``entry`` names its driver,
``harness/entries/<entry>.py``, and its ``check`` (the entry by default)
the judge of ``correct``, ``harness/checks/<check>.py``; ``module`` finds
those three. A later change adds a configuration, a family, a mix, an
entry, a check or a metric as new files and entries; nothing here or in
the harness names one.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class MissingFile(RuntimeError):
    """A file that the manifest names is not in the checkout."""


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration file's contents
    traffic: Dict  # the traffic file's contents
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _read_json(path: str, what: str) -> Dict:
    if not os.path.isfile(path):
        raise MissingFile(f"{what}: {os.path.relpath(path, ROOT)} is not in the checkout")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> Dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"), "the manifest")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, its traffic and the metrics
    it reports; raises ``MissingFile`` where a named file is absent."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r} names configuration {w['config']!r}, which BENCHMARK.json lacks")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]), f"configuration {w['config']!r}")
    traffic = _read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"), f"traffic {w['traffic']!r}")
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    for m in per_layer:
        if not os.path.isfile(metric_path(m["name"])):
            raise MissingFile(f"per-layer metric {m['name']!r}: {os.path.relpath(metric_path(m['name']), root)} "
                              "is not in the checkout")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=per_layer)


def loose_cell(config: str, traffic: str, root: str = ROOT) -> Cell:
    """A cell of a configuration and a traffic mix by their names, whether
    or not the manifest has it (for the tools that ground a new cell)."""
    configs = {c["name"]: c for c in load_manifest(root)["configs"]}
    return Cell(name=f"{config}.{traffic}", chips=1,
                config=_read_json(os.path.join(root, configs[config]["file"]), f"configuration {config!r}"),
                traffic=_read_json(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json"), f"traffic {traffic!r}"))


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def module(kind: str, name: str):
    """``harness/<kind>/<name>.py`` as a module, for ``kind`` ``families``,
    ``entries`` or ``checks``; raises ``MissingFile`` where it is absent."""
    path = os.path.join(BENCH_DIR, "harness", kind, f"{name}.py")
    if not MODULE_NAME.match(str(name)) or not os.path.isfile(path):
        raise MissingFile(f"{kind} {name!r}: {os.path.relpath(path, ROOT)} is not in the checkout")
    return importlib.import_module(f"harness.{kind}.{name}")
