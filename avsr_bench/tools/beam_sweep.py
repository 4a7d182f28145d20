"""One warm ``Speech2Text.nbest`` call at each batch (run on the card):
wall, device busy time and idle share (``torch.profiler``, device events
only), peak memory and the beam steps run (the step write's launches).

python3 avsr_bench/tools/beam_sweep.py --config <name> --traffic <name> --batches 32 128 512 --seed 5
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

from harness import drivers, manifest  # noqa: E402
from harness import traffic as tf  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--batches", type=int, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args()
    cell = manifest.loose_cell(args.config, args.traffic)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    driver = drivers.make(cell, args.seed, device)
    for b in args.batches:
        batch = tf.make_pool(args.seed, dict(cell.traffic, batch=b, pool=1))[0]
        driver.call(batch)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5 = drivers.kernel_counters()["K5"]
        t0 = time.perf_counter()
        driver.call(batch)
        wall = time.perf_counter() - t0
        steps = drivers.kernel_counters()["K5"] - k5
        peak = torch.cuda.max_memory_allocated()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            driver.call(batch)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        print(json.dumps({"batch": b, "wall_s": wall, "steps": steps, "speech_s": tf.speech_seconds(batch),
                          "speech_per_s": tf.speech_seconds(batch) / wall, "peak_bytes": peak,
                          "profiled_wall_s": pwall, "busy_s": busy, "idle_share": 1.0 - busy / pwall}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
