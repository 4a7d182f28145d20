"""A configuration of a new family, under a mix with a check of its own,
is added as new files and manifest entries only: in a copy of the
benchmark, a family that is a renamed copy of ``tailored_avsr``, a
configuration naming it, a check that delegates to ``greedy``, a mix
naming that check, a limits file and a cell run end to end on the CPU at
tiny widths (``main.measure`` and ``tools/readings.readings``), and no
file that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

RUN = """
import json, os, sys, time
sys.path[:0] = [os.path.abspath(p) for p in ("avsr_bench/tests", "avsr_bench/tools", "avsr_bench", ".")]
import torch
import harness, readings, tiny
from harness import drivers, main

c = tiny.cell("copied_avsr_greedy", dtype="float32")
result, compared = main.measure(c, 2 ** 31 + 5, 0.5, False, torch.device("cpu"), time.perf_counter())
d = drivers.make(c, 7, torch.device("cpu"))
r = readings.readings(c, d, 2 ** 31 + 6, torch.device("cpu"))
print(json.dumps({"correct": result["correct"], "compared": compared, "readings": r,
                  "family": d.family.__name__, "reference": type(d.family.build(d.cfg, d.cfg["vocab"])).__module__,
                  "harness": list(harness.__path__)}))
"""


def _hashes(top):
    out = {}
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [n for n in dirnames if n != "__pycache__"]
        for n in filenames:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _write(path, text):
    assert not os.path.exists(path), path
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def test_a_new_family_check_mix_and_cell_are_new_files_only(tmp_path):
    bench = tmp_path / "avsr_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for name in ("tailored_avsr_tpu_torch", "tokenizers", "configs"):  # the program and its data, not copied
        (tmp_path / name).symlink_to(os.path.join(ROOT, name))
    before = _hashes(bench)
    with open(tmp_path / "BENCHMARK.json", encoding="utf-8") as f:
        manifest = json.load(f)
    old = json.loads(json.dumps(manifest))

    # the family: its plain model and its glue, renamed copies of tailored_avsr's
    shutil.copy(bench / "reference" / "tailored_avsr.py", bench / "reference" / "copied_avsr.py")
    glue = (bench / "harness" / "families" / "tailored_avsr.py").read_text(encoding="utf-8")
    renamed = glue.replace("from reference import tailored_avsr as ref", "from reference import copied_avsr as ref")
    assert renamed != glue
    _write(bench / "harness" / "families" / "copied_avsr.py", renamed)
    # a configuration naming it
    config = json.loads((bench / "configs" / "tailored_avsr_es_bf16.json").read_text(encoding="utf-8"))
    config.update(name="copied_avsr_es", family="copied_avsr")
    _write(bench / "configs" / "copied_avsr_es.json", json.dumps(config, indent=1))
    # a check of its own that delegates to greedy, and a mix naming it
    _write(bench / "harness" / "checks" / "copied_greedy.py",
           '"""The greedy check, under another name."""\n\nfrom .greedy import judge, readings  # noqa: F401\n')
    mix = json.loads((bench / "traffic" / "long_24x20s.json").read_text(encoding="utf-8"))
    _write(bench / "traffic" / "copied_long.json", json.dumps(dict(mix, check="copied_greedy"), indent=1))
    # its limits and the cell
    _write(bench / "limits" / "copied_avsr_greedy.json", json.dumps({"ctc_gap_nats": 1e-3}))
    entry = next(c for c in manifest["configs"] if c["name"] == "tailored_avsr_es_bf16")
    manifest["configs"].append(dict(entry, name="copied_avsr_es", file="avsr_bench/configs/copied_avsr_es.json"))
    manifest["workloads"].append({"name": "copied_avsr_greedy", "config": "copied_avsr_es", "traffic": "copied_long",
                                  "chips": 1, "why": "a renamed copy of the flagship's family under a copied check"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1), encoding="utf-8")

    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["compared"]["ctc_gap_nats"]["limit"] == 1e-3, got["compared"]
    assert got["family"] == "harness.families.copied_avsr" and got["reference"] == "reference.copied_avsr"
    assert {os.path.realpath(p) for p in got["harness"]} == {os.path.realpath(bench / "harness")}
    r = got["readings"]
    assert r["sound"]["ctc_gap_nats"] < 1e-4 and r["sound"]["answers_missing"] == 0
    assert r["token_altered"]["ctc_gap_nats"] > r["sound"]["ctc_gap_nats"] and r["half_batch"]["answers_missing"] > 0

    after = _hashes(bench)
    assert {k: after[k] for k in before} == before  # no file that was there changed
    assert set(after) - set(before) == {"reference/copied_avsr.py", "harness/families/copied_avsr.py",
                                        "harness/checks/copied_greedy.py", "configs/copied_avsr_es.json",
                                        "traffic/copied_long.json", "limits/copied_avsr_greedy.json"}
    with open(tmp_path / "BENCHMARK.json", encoding="utf-8") as f:
        new = json.load(f)
    assert all(new[k][:len(v)] == v if isinstance(v, list) else new[k] == v for k, v in old.items())
