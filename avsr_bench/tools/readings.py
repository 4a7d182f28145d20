"""Readings that a cell's limits are set from (run on the card).

For each seed: the program's sound answers to the pool (the timed entry,
as a run calls it), then the control (the reference in the nearest
precision below the configuration's, put in the program's place) and the
planted faults, all judged as a run judges its window: the cell's check
(``harness/checks/<check>.py``) says how.

python3 avsr_bench/tools/readings.py --workload <cell> --seeds 11 12 13 [--out FILE]

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

from harness import check, drivers, manifest  # noqa: E402
from harness import traffic as tf  # noqa: E402


def readings(cell, driver, seed: int, device) -> dict:
    """The readings of ``seed``: the driver's weights and the pool made
    anew from it, then the cell's check's readings."""
    driver.load(seed)
    pool = tf.make_pool(seed, cell.traffic)
    threshold = float(check.limits(cell.name).get(check.THRESHOLD, float("inf")))
    return dict({"seed": seed}, **check.find(cell.traffic).readings(cell, driver, device, pool, threshold))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args()
    cell = manifest.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    driver = drivers.make(cell, args.seeds[0], device)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = dict(readings(cell, driver, seed, device), workload=cell.name, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        lines.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a", encoding="utf-8") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
