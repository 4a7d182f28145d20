"""One run of one cell: set-up, the measured window, the metrics, the
check of what the window served, and the result line.

``python avsr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Set-up (``setup_s``, from the process's start): importing torch and the
program, building the kernels (only in a checkout's first run), building
``Speech2Text``, loading the seeded weights, making the traffic pool and
one warm call on each pool batch. The window then calls the entry back to
back (one client, a closed loop) until ``--seconds`` have passed; every
call it starts, it finishes. With ``--trace 1`` the window (at most
``TRACE_SECONDS``) runs under ``torch.profiler`` with the metrics' ranges
installed, and the per-layer metrics are reported instead of the
end-to-end ones.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from typing import Dict, List, Optional

TRACE_SECONDS = 5.0


def _args(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _load_reader(name: str):
    from .manifest import metric_path

    spec = importlib.util.spec_from_file_location("avsr_bench_metric_" + name.replace(".", "_"), metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a metric reader reads: the cell (``cfg``: the configuration
    with ``vocab``; ``lm_cfg``; ``traffic``; ``dtype``: the served type;
    ``batch``; ``frames``: the encoder's padded length), the traced window
    (``trace``: ``harness/trace.Reduced``; ``calls``; ``steps``: the beam
    steps of each call), the kernel launches over the window
    (``launches``), the FLOPs of one call of the entry (``flops_per_call``,
    the family's count) and the host seconds of each call under each
    wrapped function's range (``host_s``)."""

    def __init__(self, cell, driver, calls, trace, launches, flops_per_call, host_s=None):
        from . import traffic as tf

        t = cell.traffic
        self.cell, self.traffic, self.cfg, self.dtype = cell, t, driver.cfg, driver.dtype
        self.batch = int(t["batch"])
        self.frames = driver.family.encoder_frames(self.cfg, *tf.buffer(t))
        self.calls, self.trace, self.launches = len(calls), trace, launches
        self.flops_per_call = flops_per_call
        self.lm_cfg = cell.config.get("lm")
        self.steps = [c[3] for c in calls]
        self.host_s = host_s or {}

    def step_positions(self):
        """Every beam step's position (1-based) over the window's calls."""
        return [pos for s in self.steps for pos in range(1, s + 1)]


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = _args(argv)
    from . import manifest

    cell = manifest.cell(args.workload)  # refuses, by name, a cell whose files are missing

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"avsr_bench: {args.workload} needs {cell.chips} CUDA device(s), found {have}; no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, compared = measure(cell, args.seed, args.seconds, bool(args.trace), device, t_start)

    from . import guard

    found = guard.forbidden_modules()
    if found:
        print(f"avsr_bench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]} for k, v in compared.items()}
    for k, v in compared.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set-up, window, metrics and check of one run on ``device``; returns
    the result (without ``checks``) and the compared numbers."""
    import torch

    # the precision the configuration states: float32 products in float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    from . import check, drivers, stats
    from . import trace as tr
    from . import traffic as tf

    driver = drivers.make(cell, seed, device)
    pool = tf.make_pool(seed, cell.traffic)
    readers = {m["name"]: _load_reader(m["name"]) for m in cell.per_layer} if trace else {}
    host_s: Dict[str, List[float]] = {}
    counters = dict(getattr(driver.family, "LAUNCH_COUNTERS", {}))
    for r in readers.values():
        counters.update(getattr(r, "LAUNCH_COUNTERS", {}))
    if trace:
        spans: Dict[str, List[str]] = {}
        ranges: Dict[str, str] = {}
        for r in readers.values():
            for k, v in getattr(r, "SPANS", {}).items():
                spans.setdefault(k, []).extend(v)
            ranges.update(getattr(r, "HOST_RANGES", {}))
        tr.install_spans(driver.engine.model, spans)
        host_s = tr.install_host_ranges(ranges, device)
    for batch in pool:  # every shape the window uses
        driver.call(batch)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    for seconds_list in host_s.values():
        seconds_list.clear()

    limit_s = min(seconds, TRACE_SECONDS) if trace else seconds
    calls: List = []
    counters0 = drivers.kernel_counters(counters)
    steps_before = counters0["K5"]  # the step write launches once a beam step
    prof = tr.profiler() if trace else None
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    while True:
        p = len(calls) % len(pool)
        c0 = time.perf_counter()
        if prof is not None:
            with torch.autograd.profiler.record_function(tr.CALL):
                out = driver.call(pool[p])
        else:
            out = driver.call(pool[p])
        c1 = time.perf_counter()
        steps = drivers.kernel_counters(counters)["K5"]
        calls.append((p, out, c1 - c0, steps - steps_before))
        steps_before = steps
        if c1 - t0 >= limit_s:
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        _sync(device)
        prof.stop()
    launches = {k: v - counters0[k] for k, v in drivers.kernel_counters(counters).items()}
    cuda = device.type == "cuda"
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}

    t = cell.traffic
    flops_per_call = driver.family.call_flops(driver.cfg, t)
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if trace:
        reduced = tr.Reduced(prof, window_s, len(calls))
        del prof
        run = Run(cell, driver, calls, reduced, launches, flops_per_call, host_s)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, reader in readers.items():
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        device_info.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        breakdown = {"device_ops": [[n, s] for n, s in reduced.device_ops()],
                     "idle_gaps": [[n, s] for n, s in reduced.idle_gaps]}
    else:
        speech = sum(tf.speech_seconds(pool[p]) for p, _, _, _ in calls)
        walls_ms = [w * 1e3 for _, _, w, _ in calls]
        values = {"setup_s": setup_s, f"{t['family']}_speech_per_s": stats.rate(speech, window_s),
                  f"{t['family']}_p90_ms": stats.percentile(walls_ms, 90)}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    # the check, once the window has closed and the peak is read
    answers = [(p, out) for p, out, _, _ in calls]
    del calls
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limit = check.limits(cell.name)
    numbers = check.judge(cell, driver, pool, answers, device, float(limit.get(check.THRESHOLD, math.inf)))
    correct, compared = check.verdict(numbers, limit)
    attempted = sum(tf.utterances(pool[p]) for p, _ in answers)
    failed = int(numbers.get("answers_missing", 0))

    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, compared


def _num(x: float):
    return x if math.isfinite(x) else str(x)
