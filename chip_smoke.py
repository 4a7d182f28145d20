"""GPU smoke run of the PyTorch/CUDA port (``tailored_avsr_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

1. Exits non-zero at once when no CUDA device is present.
2. Prints the card's name and power limit, turns TF32 off.
3. Builds the CUDA kernels from ``tailored_avsr_tpu_torch/csrc`` (timed).
4. Kernel phases: each hand-written kernel against its plain PyTorch version
   on the card, in f32 and bf16, at the shapes the serving path gives it;
   max abs error, tolerance, and median times over 25 runs (CUDA events).
5. Main path: the flagship serving model (the ``_tpu.yaml`` values, 12
   blocks, 256-d, random weights from a seed) with ``use_flash`` and
   ``use_fused_csgu`` on serves two requests through
   ``Speech2Text.greedy``: 32 x 4 s (encoder T = 100, K2 runs) and
   24 x 20 s (T = 500, K1 runs), in bf16, and the first in f32 too. The f32
   request is served again on the eager path (kernels off): the greedy ids
   must be identical and the CTC log-probs agree within 1e-3. Launch counts
   of every kernel over the main path must be > 0.
6. Prints one JSON line of per-kernel results, then the result line
   ``{"ok": true, "device": {...}}`` last.

Any failed phase raises, so the run exits non-zero and prints no result line.
Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs/AVSR/tailored_transformer+ctc_spanish_tpu.yaml")
N_TIMED = 25

# Tolerances for kernel vs plain version on the same inputs, |got - want| <=
# atol + rtol * |want|. f32: both sum in f32 in different orders (FMA loops vs
# cuBLAS / cuDNN); outputs are O(1). bf16: the plain attention rounds its
# scores (|s| up to ~40 before the 1/8 scale: 0.125 per ulp) and its
# probabilities to bf16 where the kernel keeps f32, and both round the output
# to bf16 (2^-8 relative); the csgu gate rounds only its output.
TOL = {
    ("attention", torch.float32): (1e-4, 1e-4),
    ("attention", torch.bfloat16): (5e-2, 2e-2),
    ("csgu", torch.float32): (1e-4, 1e-4),
    ("csgu", torch.bfloat16): (1e-2, 2 ** -7),
}


def _time_ms(fn, n: int = N_TIMED) -> float:
    """Median device time of one call over n calls, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _compare(name, kind, got, want):
    atol, rtol = TOL[(kind, want.dtype)]
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    excess = float((diff - rtol * want.float().abs()).max())
    ok = bool(torch.isfinite(got.float()).all()) and excess <= atol
    print(f"  {name}: max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}*|ref| -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {err:.3e})")
    return err


def _lengths_mask(gen, b, t, device):
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
    lens[0] = t
    return torch.arange(t, device=device)[None, :] < lens[:, None]


def kernel_phases(device) -> dict:
    """Each kernel against its plain version; returns per-kernel results of
    the bf16 phase at the main-path shape (the dtype the flagship serves in)."""
    from tailored_avsr_tpu_torch.ops import flash_attention as fa
    from tailored_avsr_tpu_torch.ops import fused_csgu as fc

    gen = torch.Generator(device=device).manual_seed(0)
    results = {}

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    h, dk = 4, 64
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        # K1: in-kernel rel-pos, request (b) shapes
        b, t = 24, 500
        q, k, v, qr = (randn(b, h, t, dk, dtype=dtype) for _ in range(4))
        pos = randn(h, 2 * t - 1, dk, dtype=dtype)
        mask = _lengths_mask(gen, b, t, device)
        args = (q, k, v, qr, pos, mask)
        err = _compare(f"K1 flash_attention_relpos {tag} B={b} H={h} T={t} dk={dk}", "attention",
                       fa.flash_attention_relpos(*args), fa.flash_attention_relpos_plain(*args))
        ms = _time_ms(lambda: fa.flash_attention_relpos(*args))
        plain_ms = _time_ms(lambda: fa.flash_attention_relpos_plain(*args))
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results["K1", tag] = (err, ms, plain_ms)

        # K2: streamed bias and no bias, request (a) shapes
        b, t = 32, 100
        q, k, v = (randn(b, h, t, dk, dtype=dtype) for _ in range(3))
        bias = randn(b, h, t, t, dtype=dtype, scale=4.0)
        mask = _lengths_mask(gen, b, t, device)
        for bname, bb in (("bias", bias), ("no bias", None)):
            args = (q, k, v, bb, mask)
            err = _compare(f"K2 flash_attention {bname} {tag} B={b} H={h} T={t} dk={dk}", "attention",
                           fa.flash_attention(*args), fa.flash_attention_plain(*args))
            ms = _time_ms(lambda: fa.flash_attention(*args))
            plain_ms = _time_ms(lambda: fa.flash_attention_plain(*args))
            print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if bb is not None:
                results["K2", tag] = (err, ms, plain_ms)

        # every key of one utterance masked: its rows must be exactly 0
        mask = mask.clone()
        mask[1] = False
        got = fa.flash_attention(q, k, v, bias, mask)
        _compare(f"K2 flash_attention fully masked utterance {tag}", "attention",
                 got, fa.flash_attention_plain(q, k, v, bias, mask))
        if bool(got[1].abs().max() != 0):
            raise AssertionError("K2: a fully masked utterance must give exactly 0")
        got = fa.flash_attention_relpos(q, k, v, q, pos[:, 400:599].contiguous(), mask)
        if bool(got[1].abs().max() != 0):
            raise AssertionError("K1: a fully masked utterance must give exactly 0")

        # K3: fused cgMLP gate, request (a) shapes
        b, t, u, ks = 32, 100, 2048, 31
        x = randn(b, t, u, dtype=dtype)
        gamma = 1.0 + randn(u // 2, dtype=dtype, scale=0.1)
        beta = randn(u // 2, dtype=dtype, scale=0.1)
        w = randn(ks, 1, u // 2, dtype=dtype, scale=ks ** -0.5)
        cb = randn(u // 2, dtype=dtype, scale=0.1)
        args = (x, gamma, beta, w, cb)
        err = _compare(f"K3 fused_csgu {tag} B={b} T={t} U={u} k={ks}", "csgu",
                       fc.fused_csgu(*args), fc.fused_csgu_plain(*args))
        ms = _time_ms(lambda: fc.fused_csgu(*args))
        plain_ms = _time_ms(lambda: fc.fused_csgu_plain(*args))
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results["K3", tag] = (err, ms, plain_ms)
    return results


def _request(seed: int, batch: int, seconds: int) -> dict:
    """A batch of quantised inputs as a client sends them with
    ``device_normalize``: int16 audio at 16 kHz, uint8 88x88 lip crops at
    25 fps, per-utterance lengths between 60 % and 100 % of the buffer."""
    rs = np.random.RandomState(seed)
    samples, frames = seconds * 16000, seconds * 25
    frac = rs.uniform(0.6, 1.0, batch)
    frac[0] = 1.0
    return {
        "audio": np.clip(rs.randn(batch, samples) * 3000, -32768, 32767).astype(np.int16),
        "audio_lengths": (frac * samples).astype(np.int32),
        "video": rs.randint(0, 256, (batch, frames, 88, 88)).astype(np.uint8),
        "video_lengths": np.ceil(frac * frames).astype(np.int32),
    }


def _counts():
    from tailored_avsr_tpu_torch.ops import flash_attention as fa
    from tailored_avsr_tpu_torch.ops import fused_csgu as fc

    return {
        "K1": fa.flash_attention_relpos.launches,
        "K2": fa.flash_attention.launches,
        "K3": fc.fused_csgu.launches,
    }


def _reset_counts() -> None:
    from tailored_avsr_tpu_torch.ops import flash_attention as fa
    from tailored_avsr_tpu_torch.ops import fused_csgu as fc

    fa.flash_attention_relpos.launches = 0
    fa.flash_attention.launches = 0
    fc.fused_csgu.launches = 0


def _serve(engine, name: str, batch: dict) -> list:
    """One request through ``Speech2Text.greedy``; prints its wall time (the
    transcripts are on the host when greedy returns)."""
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = engine.greedy(batch)
    wall = time.perf_counter() - t0
    after = _counts()
    launched = {k: after[k] - before[k] for k in after}
    print(f"  {name}: {wall * 1e3:.1f} ms wall, launches {launched}")
    if len(hyps) != len(batch["audio"]):
        raise AssertionError(f"{name}: {len(hyps)} transcripts for {len(batch['audio'])} utterances")
    return hyps


def _ctc(engine, batch: dict):
    """(greedy ids, CTC log-probs, encoder lengths) of one request."""
    with torch.inference_mode():
        enc, lens, _ = engine.model.encode(*engine.inputs(batch))
        logp = engine.model.ctc.log_softmax(enc)
        ids = engine.model.ctc.argmax(enc)
    want = (*batch["video"].shape[:2], engine.model.ctc.ctc_lo.in_features)
    if tuple(enc.shape) != want or not bool(torch.isfinite(logp).all()):
        raise AssertionError(f"encoder output {tuple(enc.shape)} is not a finite {want}")
    return ids, logp, lens


def serve_phase(device) -> dict:
    """The flagship serving path with the kernels, then held against the
    eager path on the same weights; returns the main path's launch counts."""
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(FLAGSHIP)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)

    def engine(dtype: str, kernels: bool):
        c = argparse.Namespace(**vars(cfg))
        c.dtype = dtype
        c.encoder_conf = dict(cfg.encoder_conf, use_flash=kernels, use_fused_csgu=kernels)
        return Speech2Text(c, rng_seed=0, device=device)

    req_a, req_b = _request(1, 32, 4), _request(2, 24, 20)
    bf16, f32 = engine("bfloat16", True), engine("float32", True)
    print("main path: flagship (12 blocks, 256-d), use_flash + use_fused_csgu, seeded weights")
    _reset_counts()
    hyp_a = _serve(bf16, "bf16 request (a) 32 x 4 s, T=100 (first call)", req_a)
    _serve(bf16, "bf16 request (a) 32 x 4 s, T=100", req_a)
    hyp_b = _serve(bf16, "bf16 request (b) 24 x 20 s, T=500 (first call)", req_b)
    _serve(bf16, "bf16 request (b) 24 x 20 s, T=500", req_b)
    _serve(f32, "f32 request (a) 32 x 4 s, T=100 (first call)", req_a)
    _serve(f32, "f32 request (a) 32 x 4 s, T=100", req_a)
    launches = _counts()
    print(f"  launches over the main path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    print(f"  sample transcripts: (a) {hyp_a[0][:40]!r}  (b) {hyp_b[0][:40]!r}")

    print("eager path (kernels off) on the same weights:")
    ids_k, logp_k, lens_k = _ctc(f32, req_a)
    f32_eager = engine("float32", False)
    before = _counts()
    _serve(f32_eager, "f32 eager request (a)", req_a)
    ids_e, logp_e, lens_e = _ctc(f32_eager, req_a)
    if _counts() != before:
        raise AssertionError("the eager path launched a kernel")
    valid = torch.arange(ids_k.shape[1], device=device)[None] < lens_k[:, None]
    same = bool(torch.equal(lens_k, lens_e)) and bool((ids_k == ids_e)[valid].all())
    dlogp = float((logp_k - logp_e).abs()[valid].max())
    print(f"  f32 request (a): greedy ids identical: {same}; max |CTC log-prob diff| "
          f"{dlogp:.3e} (tol 1e-3)")
    if not same or dlogp > 1e-3:
        raise AssertionError("f32 kernel path disagrees with the eager path")
    bf16_eager = engine("bfloat16", False)
    for name, req in (("(a)", req_a), ("(b)", req_b)):
        ids_k, _, lens_k = _ctc(bf16, req)
        ids_e, _, _ = _ctc(bf16_eager, req)
        valid = torch.arange(ids_k.shape[1], device=device)[None] < lens_k[:, None]
        share = float((ids_k == ids_e)[valid].float().mean())
        print(f"  bf16 request {name}: share of greedy ids equal to the eager path: {share:.4f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    device = torch.device("cuda", 0)

    from tailored_avsr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s ({build.library_path().name})")

    print("kernel phases (kernel vs plain version on the card):")
    phases = kernel_phases(device)
    launches = serve_phase(device)

    sources = {
        "K1": ("flash_attention_relpos", "tailored_avsr_tpu_torch/csrc/attention.cu",
               "tailored_avsr_tpu/ops/flash_attention.py:143"),
        "K2": ("flash_attention", "tailored_avsr_tpu_torch/csrc/attention.cu",
               "tailored_avsr_tpu/ops/flash_attention.py:90"),
        "K3": ("fused_csgu", "tailored_avsr_tpu_torch/csrc/csgu.cu",
               "tailored_avsr_tpu/ops/fused_csgu.py:26"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        err, ms, plain_ms = phases[key, "bf16"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[key], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
