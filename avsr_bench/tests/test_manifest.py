"""BENCHMARK.json against the benchmark's contract, and the by-name lookup."""

import json
import os
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def test_top_level_keys_and_command(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "avsr_bench/run.py"] and m["paths"] == ["avsr_bench"]
    assert 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(manifest.ROOT, c["file"])) and c["file"].startswith("avsr_bench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank", "_size", "_units")) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds_and_sources(m):
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert p["moves"] in e2e and "bound" not in p
        for w in p["workloads"]:  # each listed cell reports the metric it moves
            assert "workloads" not in e2e[p["moves"]] or w in e2e[p["moves"]]["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(m):
    for w in m["workloads"]:
        c = manifest.cell(w["name"])
        names = {e["name"] for e in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and c.per_layer
        # the family, the entry and the check are files found by name
        manifest.module("families", c.config["family"])
        manifest.module("entries", c.traffic["entry"])
        manifest.module("checks", c.traffic.get("check", c.traffic["entry"]))


def test_lookup_by_name_refuses_a_missing_file(tmp_path, m):
    with pytest.raises(KeyError):
        manifest.cell("no_such_cell")
    root = tmp_path
    (root / "avsr_bench").mkdir()
    broken = dict(m, workloads=[dict(m["workloads"][0])])
    (root / "BENCHMARK.json").write_text(json.dumps(broken))
    with pytest.raises(manifest.MissingFile):
        manifest.cell(m["workloads"][0]["name"], root=str(root))
    for kind in ("families", "entries", "checks"):
        with pytest.raises(manifest.MissingFile):
            manifest.module(kind, "no_such_name")
        with pytest.raises(manifest.MissingFile):
            manifest.module(kind, "../harness")


def test_at_most_a_quarter_of_the_cells_take_four_chips(m):
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
