"""GPU smoke run of the PyTorch/CUDA port (``tailored_avsr_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

1. Exits non-zero at once when no CUDA device is present.
2. Prints the card's name and power limit, turns TF32 off.
3. Builds the CUDA kernels from ``tailored_avsr_tpu_torch/csrc`` (timed).
4. Kernel phases: each hand-written kernel against its plain PyTorch version
   on the card, in f32 and bf16, at the shapes the serving path gives it;
   max abs error, tolerance, and median times over 25 runs (CUDA events,
   the L2 written over before each timed call), beside the least time the
   card could take (its bound) and, where one PyTorch call computes the
   same function, that call's time. K1-K3 at the encoder's shapes, and
   bf16 K2 and K1 (tensor cores) also at T = 1, 63, 64, 65, 100, 128 and
   500 (K2 with and without bias), one utterance fully masked (exactly 0);
   beside bf16 K1 at T = 100 and 500 the bias route it replaces, timed as a
   yardstick: rel_shift(q_rel . pos^T) built and streamed through K2, or
   through ``scaled_dot_product_attention``; K4 (group
   attend) and K6 (group attend over an int8 cache) at the beam step's
   decoder and LM shapes over positions 1, 2, 17, 33, 53, 103 and two
   narrowed widths, with ancestry entries outside [0, K); at pos 53 and 103
   every forced column split and chunk of a sweep (the split ones through
   the kernel that combines partial results) held to the plain version too,
   with its time printed; and a long cache (Lc 1024) whose ancestry the
   default plan splits over blocks; K5 and K5' (cache column writes)
   bit-exact, the clamp included, on bf16, f32 and int8 caches, and the
   step write (K5's form that writes all 22 cached layers of a beam step in
   one launch, from strided step columns) bit-exact against its plain loop
   on the same three cache types, timed beside the per-layer path it
   replaces (22 K5 launches and 44 group-layout copies); P1 (the HBM
   streaming probe) against its plain version, with the four cases of
   ``scripts/bench_int8_stream.py``.
5. Greedy path: the flagship serving model (the ``_tpu.yaml`` values, 12
   blocks, 256-d, random weights from a seed) with ``use_flash`` and
   ``use_fused_csgu`` on serves two requests through
   ``Speech2Text.greedy``: 32 x 4 s (encoder T = 100, K2 runs) and
   24 x 20 s (T = 500, K1 runs), in bf16, and the first in f32 too. The f32
   request is served again on the eager path (kernels off): the greedy ids
   must be identical and the CTC log-probs agree within 1e-3. Launch counts
   of K1-K3 over this path must be > 0. Then request (b) runs five times
   more, warm (median wall printed), and once under ``torch.profiler``: the
   device's busy time, its idle share and the flash-attention kernels'
   part.
6. Beam path: the same model plus the full-width Transformer LM
   (``configs/LM/lm-spanish.yaml``, 16 layers, 512-d) serves 32 x 4 s through
   ``Speech2Text.nbest`` (beam 10, ctc 0.1, lm 0.4): bf16 twice, f32 once,
   f32 with ``fused_group_attend: false`` (the plain group attend; K4 must
   not launch), whose 1-best must agree with the K4 run (scores within 1e-3,
   or 8 f32 ulps where that is more), and bf16 with ``phase_widths``
   (n-best equal to the unphased run). Launch counts of K4 and the step
   write over this path must be > 0, the step write launching exactly once
   a beam step (the group attend once a layer and step); no decode path
   calls the per-layer K5 or K5'.
7. Int8 beam path: the same request with ``cache_dtype: int8`` and
   ``mem_dtype: int8``, the same five calls held against the plain twin (K6
   must not launch there; scores within 2e-2, and a 1-best that differs
   must be a swap of two near-tied hypotheses, see ``SCORE_ATOL``) and the
   unphased run; K6 and the step write must launch (once a step) and K4
   must not. The f32 K6 check
   runs on a second request too, and the plain twin once more on each
   request with relative noise of 1e-6 on what it quantises (a control:
   the spread that sound code shows, printed as the gate would read it).
   The share of utterances whose int8 1-best equals the
   exact bf16 run's is printed, not gated.
8. Prints one JSON line of per-kernel results (launches: K1-K3 from the
   greedy path, K4, K5 (the step write) and K5' from the beam path, K6 from
   the int8 beam path; P1 counted over both beam paths, where no serving
   code may launch it), then the result line
   ``{"ok": true, "device": {...}}`` last.

Any failed phase raises, so the run exits non-zero and prints no result line.
Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tailored_avsr_tpu_torch.ops.stream_probe import HBM_BYTES_PER_S, cold_time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs/AVSR/tailored_transformer+ctc_spanish_tpu.yaml")
LM_CONFIG = os.path.join(ROOT, "configs/LM/lm-spanish.yaml")
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# device memory 3.35 TB/s; 989 TFLOP/s in bf16 (tensor cores), 67 TFLOP/s in
# f32 outside them, 1,979 TOP/s in int8. A bound is the larger of the bytes
# a call must move (each input read once, each output written once) over
# the memory rate and the operations it does over the rate of its type.
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

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
    # group attend: f32 as attention; bf16: the plain version rounds each
    # q.k product (|q.k| up to ~30, 0.125 per ulp before the 1/8 scale) and
    # the weights to bf16 where the kernel keeps f32, and both round the
    # output to bf16
    ("group_attend", torch.float32): (1e-4, 1e-4),
    ("group_attend", torch.bfloat16): (5e-2, 2e-2),
    # K6: f32 as K4; bf16 as K4's, the plain twin also rounding the
    # dequantised cache to bf16 (2^-8 relative per element)
    ("group_attend_q", torch.float32): (1e-4, 1e-4),
    ("group_attend_q", torch.bfloat16): (5e-2, 2e-2),
    # P1: sums of about 5e5 terms of f32, in another order (relative)
    ("stream", torch.float32): (0.0, 1e-5),
}


def _bound(nbytes: float, ops: float, dtype) -> tuple:
    """(least time in ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def _result(err, ms, plain_ms, bound, library_ms=None) -> dict:
    bound_ms, bound_by = bound
    print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"library {'none' if library_ms is None else f'{library_ms:.4f} ms'}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _compare(name, kind, got, want, show=True):
    atol, rtol = TOL[(kind, want.dtype)]
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    excess = float((diff - rtol * want.float().abs()).max())
    ok = bool(torch.isfinite(got.float()).all()) and excess <= atol
    if show or not ok:
        print(f"  {name}: max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}*|ref| -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {err:.3e})")
    return err


def _lengths_mask(gen, b, t, device):
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
    lens[0] = t
    return torch.arange(t, device=device)[None, :] < lens[:, None]


def kernel_phases(device) -> dict:
    """Each encoder kernel against its plain version; returns per-kernel
    results of the bf16 phase at the main-path shape (the dtype the flagship
    serves in)."""
    from tailored_avsr_tpu_torch.ops import flash_attention as fa
    from tailored_avsr_tpu_torch.ops import fused_csgu as fc
    from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

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
        out = fa.flash_attention_relpos(*args)
        err = _compare(f"K1 flash_attention_relpos {tag} B={b} H={h} T={t} dk={dk}", "attention",
                       out, fa.flash_attention_relpos_plain(*args))
        # three (T, T, dk) products a head: q.k, the rel-pos term, p.v
        bound = _bound(_nbytes(*args, out), 6 * b * h * t * t * dk, dtype)
        results["K1", tag] = _result(err, cold_time_ms(lambda: fa.flash_attention_relpos(*args)),
                                     cold_time_ms(lambda: fa.flash_attention_relpos_plain(*args)), bound)

        # K2: streamed bias and no bias, request (a) shapes
        b, t = 32, 100
        q, k, v = (randn(b, h, t, dk, dtype=dtype) for _ in range(3))
        bias = randn(b, h, t, t, dtype=dtype, scale=4.0)
        mask = _lengths_mask(gen, b, t, device)
        for bname, bb in (("bias", bias), ("no bias", None)):
            args = (q, k, v, bb, mask)
            out = fa.flash_attention(*args)
            want = fa.flash_attention_plain(*args)
            err = _compare(f"K2 flash_attention {bname} {tag} B={b} H={h} T={t} dk={dk}", "attention",
                           out, want)
            # the one-call yardstick: SDPA with the (pre-scale) bias and the
            # key mask merged into one additive mask
            merged = torch.zeros((b, 1, 1, t), dtype=dtype, device=device).masked_fill(
                ~mask[:, None, None, :], MASK_MIN)
            if bb is not None:
                merged = merged + bb / dk ** 0.5
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=merged)
            print(f"    scaled_dot_product_attention vs plain: max abs err "
                  f"{float((lib.float() - want.float()).abs().max()):.3e} (not gated)")
            bound = _bound(_nbytes(*args, out), 4 * b * h * t * t * dk, dtype)
            r = _result(err, cold_time_ms(lambda: fa.flash_attention(*args)),
                        cold_time_ms(lambda: fa.flash_attention_plain(*args)), bound,
                        cold_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=merged)))
            if bb is not None:
                results["K2", tag] = r

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

        if dtype == torch.bfloat16:
            _k2_edges(fa, randn, gen, device)
            _k1_edges(fa, randn, gen, device)

        # K3: fused cgMLP gate, request (a) shapes
        b, t, u, ks = 32, 100, 2048, 31
        x = randn(b, t, u, dtype=dtype)
        gamma = 1.0 + randn(u // 2, dtype=dtype, scale=0.1)
        beta = randn(u // 2, dtype=dtype, scale=0.1)
        w = randn(ks, 1, u // 2, dtype=dtype, scale=ks ** -0.5)
        cb = randn(u // 2, dtype=dtype, scale=0.1)
        args = (x, gamma, beta, w, cb)
        out = fc.fused_csgu(*args)
        err = _compare(f"K3 fused_csgu {tag} B={b} T={t} U={u} k={ks}", "csgu",
                       out, fc.fused_csgu_plain(*args))
        # per gated element: LayerNorm (~8), the k-tap conv (2k), bias and gate
        bound = _bound(_nbytes(*args, out), b * t * (u // 2) * (2 * ks + 10), dtype)
        results["K3", tag] = _result(err, cold_time_ms(lambda: fc.fused_csgu(*args)),
                                     cold_time_ms(lambda: fc.fused_csgu_plain(*args)), bound)
    return results


def _k2_edges(fa, randn, gen, device) -> None:
    """bf16 K2 (tensor cores) at T across its 16-row, 16-key and 64-key
    tile edges and at request (b)'s T = 500, with and without bias, one
    utterance fully masked (exactly 0) and ragged lengths elsewhere; times
    at T = 500 beside the one-call yardstick (printed, not in the line)."""
    from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

    h, dk, dtype = 4, 64, torch.bfloat16
    for t in (1, 63, 64, 65, 100, 128, 500):
        b = 24 if t == 500 else 8
        q, k, v = (randn(b, h, t, dk, dtype=dtype) for _ in range(3))
        bias = randn(b, h, t, t, dtype=dtype, scale=4.0)
        mask = _lengths_mask(gen, b, t, device)
        mask[1] = False
        for bname, bb in (("bias", bias), ("no bias", None)):
            got = fa.flash_attention(q, k, v, bb, mask)
            _compare(f"K2 flash_attention {bname} bf16 B={b} H={h} T={t} (utterance 1 fully masked)",
                     "attention", got, fa.flash_attention_plain(q, k, v, bb, mask))
            if bool(got[1].abs().max() != 0):
                raise AssertionError(f"K2 bf16 T={t}: a fully masked utterance must give exactly 0")
            if t == 500:
                merged = torch.zeros((b, 1, 1, t), dtype=dtype, device=device).masked_fill(
                    ~mask[:, None, None, :], MASK_MIN)
                if bb is not None:
                    merged = merged + bb / dk ** 0.5
                args = (q, k, v, bb, mask)
                _result(0.0, cold_time_ms(lambda: fa.flash_attention(*args)),
                        cold_time_ms(lambda: fa.flash_attention_plain(*args)),
                        _bound(_nbytes(*args, got), 4 * b * h * t * t * dk, dtype),
                        cold_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=merged)))


def _k1_edges(fa, randn, gen, device) -> None:
    """bf16 K1 (tensor cores) at T across its 16-row, 16-key and 64-key tile
    edges and at request (b)'s T = 500, one utterance fully masked (exactly
    0) and ragged lengths elsewhere. At T = 100 (request (a)'s shape) and
    T = 500 it is timed beside the bias route it replaces (printed as a
    yardstick, not in the line): rel_shift(q_rel . pos^T) materialised and
    streamed through K2, as ``ops/attention.py`` does below its 32 MiB
    switch, or through ``scaled_dot_product_attention``."""
    from tailored_avsr_tpu_torch.ops.attention import rel_shift
    from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

    h, dk, dtype = 4, 64, torch.bfloat16
    for t in (1, 63, 64, 65, 100, 128, 500):
        b = {100: 32, 500: 24}.get(t, 8)
        q, k, v, qr = (randn(b, h, t, dk, dtype=dtype) for _ in range(4))
        pos = randn(h, 2 * t - 1, dk, dtype=dtype)
        mask = _lengths_mask(gen, b, t, device)
        mask[1] = False
        args = (q, k, v, qr, pos, mask)
        got = fa.flash_attention_relpos(*args)
        _compare(f"K1 flash_attention_relpos bf16 B={b} H={h} T={t} (utterance 1 fully masked)",
                 "attention", got, fa.flash_attention_relpos_plain(*args))
        if bool(got[1].abs().max() != 0):
            raise AssertionError(f"K1 bf16 T={t}: a fully masked utterance must give exactly 0")
        if t in (100, 500):
            def bias():
                return rel_shift(qr @ pos.transpose(-2, -1)).contiguous()

            def via_k2():
                return fa.flash_attention(q, k, v, bias(), mask)

            def via_sdpa():
                merged = torch.zeros((b, 1, 1, t), dtype=dtype, device=device).masked_fill(
                    ~mask[:, None, None, :], MASK_MIN) + bias() / dk ** 0.5
                return F.scaled_dot_product_attention(q, k, v, attn_mask=merged)

            _compare(f"  bias route via K2, T={t}", "attention", via_k2(), fa.flash_attention_relpos_plain(*args))
            _result(0.0, cold_time_ms(lambda: fa.flash_attention_relpos(*args)),
                    cold_time_ms(lambda: fa.flash_attention_relpos_plain(*args)),
                    _bound(_nbytes(*args, got), 6 * b * h * t * t * dk, dtype))
            print(f"    K1 yardstick T={t}: bias route, materialised (B, H, T, T) bias + K2 "
                  f"{cold_time_ms(via_k2):.4f} ms, + scaled_dot_product_attention "
                  f"{cold_time_ms(via_sdpa):.4f} ms, the bias alone {cold_time_ms(bias):.4f} ms "
                  f"({b * h * t * t * 2 / 2 ** 20:.1f} MiB)")


def _group_attend_bound(anc, pos, width, cache_rows_bytes, step_tensors, heads, dtype) -> tuple:
    """K4 / K6 bound from this call's data: each distinct live cache row
    (b, h, j, t) that some query's ancestry names is read once (K and V,
    with its scales for K6), plus anc's live columns and the step tensors;
    4 * dk operations per (query, live column)."""
    b, km, lc = anc.shape
    n_live = max(0, min(pos - 1, width or lc))
    a = anc[:, :, :n_live].long()
    valid = (a >= 0) & (a < km)
    key = (torch.arange(b, device=a.device)[:, None, None] * km + a.clamp(0, km - 1)) * lc \
        + torch.arange(n_live, device=a.device)
    rows = int(torch.unique(key[valid]).numel()) * heads
    dk = step_tensors[0].shape[-1]
    nbytes = rows * cache_rows_bytes + b * km * n_live * 4 + _nbytes(*step_tensors)
    return _bound(nbytes, int(valid.sum()) * heads * 4 * dk, dtype)


def _forced(shape: dict, chunk: int, split: int) -> dict:
    """``launch_shape``'s integers with the column plan forced: ``split``
    blocks a group (at least a chunk each), ``chunk`` columns a copy."""
    n = max(shape["n_live"], 1)
    per = -(-(-(-n // split)) // chunk) * chunk
    return dict(shape, chunk=chunk, per=per, split=-(-n // per))


def _plan_sweep(ga, args, qargs, tag) -> None:
    """K4 and K6 under forced column splits and chunks, each plan held to
    the plain version (the split ones run the combining kernel), with its
    L2-cold time (printed, the default plan marked): the measurement behind
    ``group_attend_plan``'s choices."""
    k, v, q, k_new, v_new, a, pos = args
    kq, ks, vq, vs = qargs[:4]
    sms = torch.cuda.get_device_properties(k.device).multi_processor_count
    for name, kind, entry, cache, scales, plain in (
            ("K4", "group_attend", "avsr_group_attend", (k, v), (), ga.group_attend_anc_plain(*args)),
            ("K6", "group_attend_q", "avsr_group_attend_q", (kq, vq), (ks, vs),
             ga.group_attend_anc_q_plain(*qargs))):
        shape = ga.launch_shape(entry, *cache, scales, q, k_new, v_new, a, pos, None, cache[0].dtype,
                                sms=sms)
        row, worst, seen = [], 0.0, []
        for chunk, split in ((shape["chunk"], 1), (shape["chunk"], 2), (shape["chunk"], 4),
                             (8, 1), (16, 1), (32, 1)):
            plan = _forced(shape, chunk, split)
            if plan in seen:
                continue
            seen.append(plan)
            desc = f"chunk {plan['chunk']} per {plan['per']} split {plan['split']}"
            if ga._smem_bytes(plan["beam"], chunk, plan["per"], cache[0].element_size()) > ga._SMEM_LIMIT:
                row.append(f"{desc}: does not fit")
                continue

            def run():
                return ga._launch(entry, *cache, scales, q, k_new, v_new, a, plan)

            worst = max(worst, _compare(f"{name} {tag} H={k.shape[1]} pos={pos} {desc}", kind, run(),
                                        plain, show=False))
            mark = " (default)" if plan == shape else ""
            row.append(f"{desc}{mark}: {cold_time_ms(run):.4f}")
        print(f"    {name} {tag} plan sweep, H={k.shape[1]} pos={pos}, every plan held to the plain version "
              f"(max abs err {worst:.3e}), ms: " + "; ".join(row))


def _split_cases(ga, randn, gen, device) -> None:
    """K4 and K6 where the default plan splits a group over blocks: a long
    cache (batch 2, LM heads, beam 10, Lc 1024) whose live columns carry
    more ancestry than one block holds. Held to the plain version in f32
    and bf16; each launch runs the kernel and the combining kernel, and the
    wrapper must count both. Times of the longest case printed."""
    from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

    b, h, km, lc, dk = 2, 8, 10, 1024, 64
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        k, v = randn(b, h, km, lc, dk, dtype=dtype), randn(b, h, km, lc, dk, dtype=dtype)
        (kq, ks), (vq, vs) = (quantize_kv_column(randn(b, h, km, lc, dk, dtype=torch.float32))
                              for _ in range(2))
        q, k_new, v_new = (randn(b, h, km, dk, dtype=dtype) for _ in range(3))
        anc = torch.randint(0, km, (b, km, lc), generator=gen, device=device, dtype=torch.int32)
        odd = torch.rand(anc.shape, generator=gen, device=device)
        anc = torch.where(odd < 0.025, -1, torch.where(odd < 0.05, km, anc)).to(torch.int32)
        splits = set()
        for pos, width in ((400, None), (700, None), (1025, None), (1025, 512)):
            plans = {c: ga.group_attend_plan(b * h, km, min(pos - 1, width or lc), c, sms=sms)
                     for c in (k.element_size(), 1)}
            shape = f"B={b} H={h} K={km} Lc={lc} pos={pos}" + (f" width={width}" if width else "")
            for name, kind, wrapper, plain, xargs, esize in (
                    ("K4", "group_attend", ga.group_attend_anc, ga.group_attend_anc_plain,
                     (k, v, q, k_new, v_new, anc, pos), k.element_size()),
                    ("K6", "group_attend_q", ga.group_attend_anc_q, ga.group_attend_anc_q_plain,
                     (kq, ks, vq, vs, q, k_new, v_new, anc, pos), 1)):
                chunk, per, split = plans[esize]
                splits.add(split)
                before = wrapper.launches
                got = wrapper(*xargs, width=width)
                launched = wrapper.launches - before
                err = _compare(f"{name} {tag} {shape}, default plan chunk {chunk} per {per} split {split}",
                               kind, got, plain(*xargs, width=width))
                if launched != (1 if split == 1 else 2):
                    raise AssertionError(f"{name}: split {split} counted {launched} launches")
                if pos == 1025 and width is None and dtype == torch.bfloat16:
                    row_bytes = 2 * (dk * k.element_size() if name == "K4" else dk + 4)
                    _result(err, cold_time_ms(lambda: wrapper(*xargs, width=width)),
                            cold_time_ms(lambda: plain(*xargs, width=width)),
                            _group_attend_bound(anc, pos, width, row_bytes, (q, k_new, v_new, got), h, dtype))
        if max(splits) < 2:
            raise AssertionError(f"no long-cache case split a group: {splits}")


def beam_kernel_phases(device) -> dict:
    """K4, K6, K5 and K5' against their plain versions at the beam step's
    shapes (request (a): batch 32, beam 10, Lc 104; decoder H = 4, LM H = 8);
    returns per-kernel results of the bf16 phase at the LM shape."""
    from tailored_avsr_tpu_torch.ops import cache_update as cu
    from tailored_avsr_tpu_torch.ops import group_attend as ga
    from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    b, km, lc, dk = 32, 10, 104, 64

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        esize = torch.finfo(dtype).bits // 8
        for h in (4, 8):
            k, v = randn(b, h, km, lc, dk, dtype=dtype), randn(b, h, km, lc, dk, dtype=dtype)
            (kq, ks), (vq, vs) = (quantize_kv_column(randn(b, h, km, lc, dk, dtype=torch.float32))
                                  for _ in range(2))
            q, k_new, v_new = (randn(b, h, km, dk, dtype=dtype) for _ in range(3))
            anc = torch.randint(0, km, (b, km, lc), generator=gen, device=device, dtype=torch.int32)
            # about 1 in 20 entries outside [0, K): they match no slot
            odd = torch.rand(anc.shape, generator=gen, device=device)
            anc = torch.where(odd < 0.025, -1, torch.where(odd < 0.05, km, anc)).to(torch.int32)
            for pos, width in ((1, None), (2, None), (17, None), (33, None), (53, None), (103, None),
                               (53, 56), (103, 32)):
                a = anc.clone()
                if width is not None:
                    a[:, :, width:] = -1
                shape = f"B={b} H={h} K={km} Lc={lc} pos={pos}" + (f" width={width}" if width else "")
                # K4 over the float cache
                args = (k, v, q, k_new, v_new, a, pos)
                got = ga.group_attend_anc(*args, width=width)
                err = _compare(f"K4 group_attend_anc {tag} {shape}", "group_attend",
                               got, ga.group_attend_anc_plain(*args, width=width))
                if pos == 1 and not torch.equal(got, v_new):
                    raise AssertionError("K4: at pos 1 the output must be exactly v_new")
                bound = _group_attend_bound(a, pos, width, 2 * dk * esize, (q, k_new, v_new, got), h, dtype)
                r4 = _result(err, cold_time_ms(lambda: ga.group_attend_anc(*args, width=width)),
                             cold_time_ms(lambda: ga.group_attend_anc_plain(*args, width=width)), bound)
                # K6 over the int8 payload and its f32 column scales
                qargs = (kq, ks, vq, vs, q, k_new, v_new, a, pos)
                got = ga.group_attend_anc_q(*qargs, width=width)
                err = _compare(f"K6 group_attend_anc_q {tag} {shape}", "group_attend_q",
                               got, ga.group_attend_anc_q_plain(*qargs, width=width))
                if pos == 1 and not torch.equal(got, v_new):
                    raise AssertionError("K6: at pos 1 the output must be exactly v_new")
                bound = _group_attend_bound(a, pos, width, 2 * (dk + 4), (q, k_new, v_new, got), h, dtype)
                r6 = _result(err, cold_time_ms(lambda: ga.group_attend_anc_q(*qargs, width=width)),
                             cold_time_ms(lambda: ga.group_attend_anc_q_plain(*qargs, width=width)), bound)
                if h == 8 and pos == 53 and width is None:
                    results["K4", tag], results["K6", tag] = r4, r6
                if pos in (53, 103) and width is None:
                    _plan_sweep(ga, args, qargs, tag)
    _split_cases(ga, randn, gen, device)

    # K5 / K5': bit-exact in-place column writes at the LM shape
    h = 8
    for cache_dtype, col_dtype in ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                                   (torch.int8, torch.int8)):
        names = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}
        tag = f"{names[cache_dtype]} cache, {names[col_dtype]} columns"
        if cache_dtype == torch.int8:
            kc, vc = (torch.randint(-127, 128, (b, h, km, lc, dk), generator=gen, device=device,
                                    dtype=torch.int8) for _ in range(2))
            kcol, vcol = (torch.randint(-127, 128, (b, h, km, dk), generator=gen, device=device,
                                        dtype=torch.int8) for _ in range(2))
        else:
            kc, vc = randn(b, h, km, lc, dk, dtype=cache_dtype), randn(b, h, km, lc, dk, dtype=cache_dtype)
            kcol, vcol = randn(b, h, km, dk, dtype=col_dtype), randn(b, h, km, dk, dtype=col_dtype)
        col_bytes = kcol.numel() * (kcol.element_size() + kc.element_size())  # read + written
        for pos in (0, 57, lc):
            gk, gv = cu.write_cache_columns_kv(kc.clone(), vc.clone(), kcol, vcol, pos)
            wk, wv = cu.write_cache_columns_kv_plain(kc.clone(), vc.clone(), kcol, vcol, pos)
            g1 = cu.write_cache_column(kc.clone(), kcol, pos)
            w1 = cu.write_cache_column_plain(kc.clone(), kcol, pos)
            torch.cuda.synchronize()
            err = max(float((gk.float() - wk.float()).abs().max()),
                      float((gv.float() - wv.float()).abs().max()))
            err1 = float((g1.float() - w1.float()).abs().max())
            same = torch.equal(gk, wk) and torch.equal(gv, wv)
            same1 = torch.equal(g1, w1)
            print(f"  K5 write_cache_columns_kv {tag} pos={pos}: max_abs_err={err:.3e} tol=0 "
                  f"(bit-exact) -> {'ok' if same else 'FAIL'}")
            r5 = _result(err, cold_time_ms(lambda: cu.write_cache_columns_kv(kc, vc, kcol, vcol, pos)),
                         cold_time_ms(lambda: cu.write_cache_columns_kv_plain(kc, vc, kcol, vcol, pos)),
                         _bound(2 * col_bytes, 0, torch.float32))
            print(f"  K5' write_cache_column {tag} pos={pos}: max_abs_err={err1:.3e} tol=0 "
                  f"(bit-exact) -> {'ok' if same1 else 'FAIL'}")
            col = min(pos, lc - 1)

            def library():  # the one-call yardstick: indexed assignment, cast included
                kc[:, :, :, col] = kcol

            r5p = _result(err1, cold_time_ms(lambda: cu.write_cache_column(kc, kcol, pos)),
                          cold_time_ms(lambda: cu.write_cache_column_plain(kc, kcol, pos)),
                          _bound(col_bytes, 0, torch.float32), cold_time_ms(library))
            if not (same and same1):
                raise AssertionError(f"K5/K5' disagree with the plain write ({tag}, pos {pos})")
            if cache_dtype == torch.bfloat16 and pos == 57:
                results["K5'", "bf16"] = r5p
    results["K5", "bf16"] = _step_write_phase(cu, gen, device)
    return results


def _host_ms(fn, n: int = 50) -> float:
    """Mean host time of one call of ``fn`` (its Python and launch
    enqueue), over ``n`` calls after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def _step_write_phase(cu, gen, device) -> dict:
    """The step write at the flagship's beam step (request (a): batch 32,
    beam 10, Lc 104; 6 decoder layers with H = 4 and 16 LM layers with H = 8,
    dk 64), its step columns strided (N, H, 1, dk) views of one fused q/k/v
    projection as the scorers give them: bit-exact against its plain loop on
    bf16, f32 and int8 caches (bf16 columns quantised, as the int8 beam
    does) at pos 1, 53 and 106 (past Lc: the clamp), one launch each. At pos
    53 its L2-cold time beside the per-layer path it replaces (22 K5
    launches on 44 group-layout copies; on the int8 cache also 44 indexed
    scale writes). Returns the bf16 cache's results at pos 53."""
    from tailored_avsr_tpu_torch.ops.group_attend import to_group
    from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

    b, km, lc, dk = 32, 10, 104, 64
    n, heads = b * km, [4] * 6 + [8] * 16
    names = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}
    result = None
    for cache_dtype in (torch.bfloat16, torch.float32, torch.int8):
        int8 = cache_dtype == torch.int8
        col_dtype = torch.bfloat16 if int8 else cache_dtype

        def side(h):
            if int8:
                return (torch.randint(-127, 128, (b, h, km, lc, dk), generator=gen, device=device,
                                      dtype=torch.int8),
                        torch.rand(b, h, km, lc, generator=gen, device=device))
            return torch.randn(b, h, km, lc, dk, generator=gen, device=device).to(cache_dtype)

        def step(h):
            y = torch.randn(n, 1, 3 * h * dk, generator=gen, device=device).to(col_dtype)
            kv = [y[..., j * h * dk:(j + 1) * h * dk].reshape(n, 1, h, dk).transpose(1, 2) for j in (1, 2)]
            return [quantize_kv_column(x) for x in kv] if int8 else kv

        leaves = [(side(h), side(h), *step(h)) for h in heads]

        def flat(ls):
            return [t for leaf in ls for x in leaf[:2] for t in (x if isinstance(x, tuple) else (x,))]

        def clone(ls):
            return [tuple(tuple(t.clone() for t in x) if isinstance(x, tuple) else x.clone() for x in leaf[:2])
                    + tuple(leaf[2:]) for leaf in ls]

        tag = f"{names[cache_dtype]} cache, {names[col_dtype]} columns" + (" (quantised)" if int8 else "")
        for pos in (1, 53, lc + 2):
            got, want = clone(leaves), clone(leaves)
            before = cu.write_step_columns.launches
            cu.write_step_columns(got, pos)
            launched = cu.write_step_columns.launches - before
            cu.write_step_columns_plain(want, pos)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(flat(got), flat(want)))
            err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(flat(got), flat(want)))
            print(f"  K5 step write, {len(heads)} layers, {tag}, pos={pos}: max_abs_err={err:.3e} tol=0 "
                  f"(bit-exact), {launched} launch -> {'ok' if same and launched == 1 else 'FAIL'}")
            if not same or launched != 1:
                raise AssertionError(f"the step write disagrees with its plain loop ({tag}, pos {pos}) "
                                     f"or took {launched} launches")
        del got, want
        pos = 53

        def per_layer():  # the path the step write replaces, as the beam ran it before
            for ck, cv, kn, vn in leaves:
                if int8:
                    (ck, ks), (cv, vs), (kn, ksn), (vn, vsn) = ck, cv, kn, vn
                    ks[:, :, :, pos - 1] = to_group(ksn[..., None], km)[..., 0]
                    vs[:, :, :, pos - 1] = to_group(vsn[..., None], km)[..., 0]
                cu.write_cache_columns_kv(ck, cv, to_group(kn, km), to_group(vn, km), pos - 1)

        # each step column read once, each cache column (and int8 scale) written once
        srcs = [t for leaf in leaves for x in leaf[2:] for t in (x if isinstance(x, tuple) else (x,))]
        nbytes = _nbytes(*srcs) + sum(x.numel() * cache_dtype.itemsize for leaf in leaves
                                      for x in (leaf[2][0] if int8 else leaf[2], leaf[3][0] if int8 else leaf[3]))
        if int8:
            nbytes += sum(leaf[2][1].numel() + leaf[3][1].numel() for leaf in leaves) * 4
        r = _result(0.0, cold_time_ms(lambda: cu.write_step_columns(leaves, pos)),
                    cold_time_ms(lambda: cu.write_step_columns_plain(leaves, pos)),
                    _bound(nbytes, 0, torch.float32))
        print(f"    step write {tag}: per-layer path it replaces (22 K5 + 44 to_group copies"
              f"{' + 44 scale writes' if int8 else ''}) {cold_time_ms(per_layer):.4f} ms; host time "
              f"a call: step write {_host_ms(lambda: cu.write_step_columns(leaves, pos)):.3f} ms, "
              f"per-layer path {_host_ms(per_layer):.3f} ms")
        if cache_dtype == torch.bfloat16:
            result = r
        del leaves
    return result


def probe_phase(device) -> dict:
    """P1 against its plain version (relative 1e-5) on the four cases of
    ``scripts/bench_int8_stream.py`` and on a row whose length is no
    multiple of 16 bytes (the one-element path); returns the bf16 case's
    results, with ``torch.linalg.vector_norm`` as the one-call yardstick
    (it takes no int8)."""
    from tailored_avsr_tpu_torch.ops import stream_probe as sp

    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(5, 3, 1001, generator=gen, device=device).to(torch.bfloat16)
    _compare("P1 stream_abs_sum bf16 (5, 3, 1001), unaligned rows", "stream",
             sp.stream_abs_sum(x), sp.stream_abs_sum_plain(x))
    results = {}
    for row in sp.run_probe(device):
        ok = row["max_rel_err"] <= TOL["stream", torch.float32][1]
        print(f"  P1 {row['case']} {tuple(row['shape'])} {row['dtype']}: allocated {row['alloc_mb']:.1f} MB, "
              f"max_abs_err={row['max_abs_err']:.3e} max_rel_err={row['max_rel_err']:.3e} (tol 1e-5) -> "
              f"{'ok' if ok else 'FAIL'}; kernel {row['ms']:.4f} ms = {row['gb_per_s']:.1f} GB/s "
              f"({row['hbm_share']:.3f} of 3.35 TB/s), plain {row['plain_ms']:.4f} ms")
        if not ok:
            raise AssertionError(f"P1 {row['case']}: kernel disagrees with its plain version")
        if row["case"] == "bf16_dk64":
            x = torch.randn(row["shape"], generator=gen, device=device).to(torch.bfloat16)
            # an abs and an add per element; the (B,) f32 sums out
            bound = _bound(row["bytes"] + 4 * x.shape[0], 2 * x.numel(), torch.bfloat16)
            library_ms = cold_time_ms(lambda: torch.linalg.vector_norm(x.flatten(1), 1, dim=1,
                                                                   dtype=torch.float32))
            results["P1", "bf16"] = _result(row["max_abs_err"], row["ms"], row["plain_ms"], bound,
                                            library_ms)
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


def _wrappers() -> dict:
    from tailored_avsr_tpu_torch.ops import cache_update as cu
    from tailored_avsr_tpu_torch.ops import flash_attention as fa
    from tailored_avsr_tpu_torch.ops import fused_csgu as fc
    from tailored_avsr_tpu_torch.ops import group_attend as ga
    from tailored_avsr_tpu_torch.ops import stream_probe as sp

    return {"K1": fa.flash_attention_relpos, "K2": fa.flash_attention, "K3": fc.fused_csgu,
            "K4": ga.group_attend_anc, "K5": cu.write_step_columns, "K5 layer": cu.write_cache_columns_kv,
            "K5'": cu.write_cache_column, "K6": ga.group_attend_anc_q, "P1": sp.stream_abs_sum}


def _counts() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def _reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def _serve(engine, name: str, batch: dict) -> list:
    """One request through ``Speech2Text.greedy``; prints its wall time (the
    transcripts are on the host when greedy returns)."""
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = engine.greedy(batch)
    wall = time.perf_counter() - t0
    after = _counts()
    launched = {k: after[k] - before[k] for k in ("K1", "K2", "K3")}
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


def _greedy_engine(device, dtype: str, kernels: bool):
    """The flagship serving model, seeded weights, with ``use_flash`` and
    ``use_fused_csgu`` on (``kernels``) or off (the eager path)."""
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(FLAGSHIP)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.dtype = dtype
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=kernels, use_fused_csgu=kernels)
    return Speech2Text(cfg, rng_seed=0, device=device)


def _walls(fn, repeats: int) -> list:
    """Host wall ms of ``repeats`` calls of ``fn``, each started on an idle
    device (``fn`` returns host data, so its end waits for the device)."""
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def nbest_walls(engine, batch: dict, name: str, repeats: int = 3) -> float:
    """Warm wall times of ``repeats`` ``Speech2Text.nbest`` calls; prints
    them and returns their median."""
    walls = _walls(lambda: engine.nbest(batch), repeats)
    print(f"  {name}: warm wall ms {', '.join(f'{w:.1f}' for w in walls)} (median {np.median(walls):.1f})")
    return float(np.median(walls))


def greedy_profile(engine, batch: dict, name: str, repeats: int = 5) -> dict:
    """Warm wall times of ``repeats`` ``Speech2Text.greedy`` calls (median),
    then one call under ``torch.profiler``: the device's busy time (the sum
    of its kernels' and copies' times; one stream, so they do not overlap),
    its idle share of that call's wall time, and the flash-attention
    kernels' part of the busy time."""
    walls = _walls(lambda: engine.greedy(batch), repeats)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.greedy(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies, sets); a CPU op's device
    # time repeats its kernels' and is not summed
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    flash = sum(e.self_device_time_total for e in events if "flash_attention" in e.key) / 1e3
    out = {"median_wall_ms": float(np.median(walls)), "profiled_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall, "flash_ms": flash}
    print(f"  {name}: warm wall ms {', '.join(f'{w:.1f}' for w in walls)} (median {out['median_wall_ms']:.1f}); "
          f"profiled call: device busy {busy:.2f} ms of {wall:.2f} ms wall (idle share {out['idle_share']:.3f}), "
          f"flash-attention kernels {flash:.2f} ms")
    return out


def serve_phase(device) -> dict:
    """The flagship serving path with the kernels, then held against the
    eager path on the same weights; returns the main path's launch counts.
    Request (b), where K1 runs, is profiled after the counted calls."""
    def engine(dtype: str, kernels: bool):
        return _greedy_engine(device, dtype, kernels)

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
    launches = {k: v for k, v in _counts().items() if k in ("K1", "K2", "K3")}
    print(f"  launches over the greedy path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    print(f"  sample transcripts: (a) {hyp_a[0][:40]!r}  (b) {hyp_b[0][:40]!r}")
    greedy_profile(bf16, req_b, "bf16 request (b) 24 x 20 s")

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


def _nbest(engine, name: str, batch: dict) -> list:
    """One request through ``Speech2Text.nbest``; prints its wall time, the
    beam steps it ran (the step write's launches: one a step) and seconds
    of speech per wall second. The cache writes must go through the step
    write alone (the per-layer K5 and K5' launch 0), and where the group
    attend ran, once a layer and step: the step write once a step."""
    layers = len(engine.model.decoder.decoders) + len(engine.lm.encoder.encoders)
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = engine.nbest(batch)
    wall = time.perf_counter() - t0
    after = _counts()
    k4, steps, k5_layer, k5p, k6 = (after[k] - before[k] for k in ("K4", "K5", "K5 layer", "K5'", "K6"))
    speech = float(np.sum(batch["audio_lengths"])) / 16000
    print(f"  {name}: {wall * 1e3:.1f} ms wall, {steps} beam steps, "
          f"{speech / wall:.1f} s of speech per wall second, launches K4 {k4} K5 (step write) {steps} K6 {k6}")
    if k5_layer or k5p or steps <= 0 or (k4 or k6) and k4 + k6 != layers * steps:
        raise AssertionError(f"{name}: the cache writes took {k5_layer} per-layer K5 and {k5p} K5' launches "
                             f"and {steps} step writes for {k4 + k6} group attends over {layers} layers")
    nbest = engine.beam_config.nbest
    if len(hyps) != len(batch["audio"]) or any(len(h) != nbest for h in hyps):
        raise AssertionError(f"{name}: expected {len(batch['audio'])} n-best lists of {nbest}")
    if not all(np.isfinite(h[3]) for hs in hyps for h in hs):
        raise AssertionError(f"{name}: a hypothesis has no finite score")
    return hyps


def _beam_engine(device, dtype: str, **inference_conf):
    """The flagship + the 16-layer LM (beam 10, ctc 0.1, lm 0.4) with the
    encoder kernels on, seeded weights."""
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(FLAGSHIP)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    lm_cfg = load_config(LM_CONFIG)
    lm_cfg.token_list = os.path.join(ROOT, lm_cfg.token_list)
    cfg.dtype = dtype
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True)
    cfg.inference_conf = dict(cfg.inference_conf, **inference_conf)
    return Speech2Text(cfg, lm_config=lm_cfg, rng_seed=0, device=device)


# f32 beam through the group-attend kernel against the plain twin (both
# with a 2-best): 1-best ids equal, scores within SCORE_ATOL or 8 f32 ulps
# where that is more (a forced finish that CTC cannot align scores about
# ctc_weight * -1e10, where an ulp is 64). K4: both sum in f32 in another
# order. K6: the same, but every step's columns are then rounded to int8
# steps of 1/127 of a column's max, and a value that lies within the two
# versions' ~1e-6 difference of a rounding boundary lands one step apart;
# each such step moves later logits by up to |q| * step / sqrt(dk), so the
# scores drift by more than the float cache's, and two hypotheses that
# close may trade places. For K6 a 1-best that differs must be such a swap:
# each run's 1-best is the other's second, at scores within the tolerance.
# A wrong kernel moves scores by O(1). Readings and the control: PERF.md.
SCORE_ATOL = {"K4": 1e-3, "K6": 2e-2}


def _score_spread(hyp, hyp_ref) -> tuple:
    """(utterances whose 1-best ids equal the reference's, largest |1-best
    score difference|)."""
    same = sum(g[0][2] == w[0][2] for g, w in zip(hyp, hyp_ref))
    return same, max(abs(g[0][3] - w[0][3]) for g, w in zip(hyp, hyp_ref))


def _noise_control(engine, req, hyp_ref, name) -> None:
    """The plain twin once more, with relative noise of 1e-6 on everything
    it quantises (the memory K/V and each step's columns): the score spread
    that the int8 rounding makes of a column gap that size in sound code.
    Printed as K6's gate would read it beside the K6 reading, not gated."""
    from tailored_avsr_tpu_torch import inference as inf_mod
    from tailored_avsr_tpu_torch.decode import beam_search as bs

    quantize = bs.quantize_kv_column
    gen = torch.Generator(device=engine.device).manual_seed(0)

    def noisy(x):
        return quantize(x * (1 + 1e-6 * torch.randn(x.shape, generator=gen, device=x.device)))

    bs.quantize_kv_column = inf_mod.quantize_kv_column = noisy
    try:
        hyp = _nbest(engine, f"f32, plain group attend, {name}, relative noise 1e-6 on the quantiser's inputs",
                     req)
    finally:
        bs.quantize_kv_column = inf_mod.quantize_kv_column = quantize
    bad = _against_plain(hyp, hyp_ref, "K6", f"noise control, {name}: plain + noise")
    print(f"  noise control, {name}: {bad} utterances beyond K6's gate (not gated)")


def _against_plain(hyp, hyp_plain, kernel: str, what: str) -> int:
    """Print how ``hyp`` reads against ``hyp_plain`` under ``kernel``'s
    gate; returns the number of utterances beyond it."""
    atol = SCORE_ATOL[kernel]

    def close(g, w):
        return abs(g[3] - w[3]) <= max(atol, 8 * float(np.spacing(np.float32(abs(w[3])))))

    worst, differ, swaps, bad, over_1e3 = 0.0, 0, 0, 0, 0
    for i, (g, w) in enumerate(zip(hyp, hyp_plain)):
        diff = abs(g[0][3] - w[0][3])
        worst = max(worst, diff)
        over_1e3 += diff > 1e-3
        if g[0][2] == w[0][2]:
            bad += not close(g[0], w[0])
            continue
        differ += 1
        swap = g[0][2] == w[1][2] and g[1][2] == w[0][2] and close(g[0], w[1]) and close(g[1], w[0])
        swaps += swap
        bad += not (swap and kernel == "K6")
        print(f"    utterance {i}: 1-best differs, {'a swap of the top two' if swap else 'NOT a swap'}: "
              f"{what} {g[0][3]:.6f}, {g[1][3]:.6f}; plain {w[0][3]:.6f}, {w[1][3]:.6f}")
    print(f"  {what} vs plain group attend: 1-best ids equal on {len(hyp) - differ}/{len(hyp)} "
          f"utterances ({swaps} near-tied swaps), max |1-best score diff| {worst:.3e} ({over_1e3} beyond "
          f"1e-3), {bad} beyond tolerance ({atol:g} or 8 ulps)")
    return bad


def _held_against_plain(hyp, hyp_plain, kernel: str) -> None:
    if _against_plain(hyp, hyp_plain, kernel, f"f32 {kernel}"):
        raise AssertionError(f"f32 beam through {kernel} disagrees with the plain group attend")


def beam_phase(device, req, **inference_conf) -> tuple:
    """The flagship beam path serving request (a); f32 held against the
    plain group attend on the card, phased widths against the unphased bf16
    run. With ``cache_dtype`` / ``mem_dtype: int8`` the group attend is K6,
    else K4. Returns the path's launch counts and the bf16 n-best."""
    kernel = "K6" if inference_conf.get("cache_dtype") == "int8" else "K4"
    bf16 = _beam_engine(device, "bfloat16", **inference_conf)
    f32 = _beam_engine(device, "float32", nbest=2, **inference_conf)
    _reset_counts()
    _nbest(bf16, "bf16 (first call)", req)
    hyp_bf16 = _nbest(bf16, "bf16", req)
    hyp_f32 = _nbest(f32, "f32", req)
    launches = _counts()
    print(f"  launches over the path: {launches}")
    nbest_walls(bf16, req, "bf16, after the counted calls")
    if min(launches[k] for k in ("K2", "K3", kernel, "K5")) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if kernel == "K6" and launches["K4"]:
        raise AssertionError("the int8 cache launched the float group-attend kernel K4")
    print(f"  sample 1-best: bf16 {hyp_bf16[0][0][0][:40]!r}  f32 {hyp_f32[0][0][0][:40]!r}")

    before = _counts()[kernel]
    plain = _beam_engine(device, "float32", fused_group_attend=False, nbest=2, **inference_conf)
    hyp_plain = _nbest(plain, "f32, plain group attend", req)
    if _counts()[kernel] != before:
        raise AssertionError("fused_group_attend: false launched the group-attend kernel")
    _held_against_plain(hyp_f32, hyp_plain, kernel)
    if kernel == "K6":  # a second request, and the plain twin under column noise on each
        req2 = _request(3, 32, 4)
        hyp_f32_2 = _nbest(f32, "f32, request (a) seed 3", req2)
        hyp_plain_2 = _nbest(plain, "f32, plain group attend, request (a) seed 3", req2)
        _held_against_plain(hyp_f32_2, hyp_plain_2, kernel)
        _noise_control(plain, req, hyp_plain, "request (a)")
        _noise_control(plain, req2, hyp_plain_2, "request (a) seed 3")

    phased = _beam_engine(device, "bfloat16", phase_widths=[0.25, 0.5], **inference_conf)
    same = _nbest(phased, "bf16, phase_widths [0.25, 0.5]", req) == hyp_bf16
    print(f"  bf16 phased n-best equal to the unphased run: {same}")
    if not same:
        raise AssertionError("phased widths changed the bf16 n-best")
    return launches, hyp_bf16


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
    phases.update(beam_kernel_phases(device))
    phases.update(probe_phase(device))
    launches = serve_phase(device)
    req = _request(1, 32, 4)
    print("beam path: flagship + 16-layer 512-d LM, beam 10, ctc 0.1, lm 0.4, seeded weights, "
          "request (a) 32 x 4 s (T=100, Lc=104)")
    beam_launches, hyp_exact = beam_phase(device, req)
    for key in ("K4", "K5", "K5'"):
        launches[key] = beam_launches[key]
    print("int8 beam path: the same, with cache_dtype: int8 and mem_dtype: int8")
    int8_launches, hyp_int8 = beam_phase(device, req, cache_dtype="int8", mem_dtype="int8")
    launches["K6"] = int8_launches["K6"]
    launches["P1"] = beam_launches["P1"] + int8_launches["P1"]
    if launches["P1"]:
        raise AssertionError("a serving path launched the streaming probe P1")
    same = sum(g[0][2] == w[0][2] for g, w in zip(hyp_int8, hyp_exact))
    print(f"  bf16 int8 1-best equal to the exact bf16 run's on {same}/{len(hyp_exact)} utterances "
          "(not gated: int8 is not exact by design, and the weights are random)")

    sources = {
        "K1": ("flash_attention_relpos", "tailored_avsr_tpu_torch/csrc/attention.cu",
               "tailored_avsr_tpu/ops/flash_attention.py:143"),
        "K2": ("flash_attention", "tailored_avsr_tpu_torch/csrc/attention.cu",
               "tailored_avsr_tpu/ops/flash_attention.py:90"),
        "K3": ("fused_csgu", "tailored_avsr_tpu_torch/csrc/csgu.cu",
               "tailored_avsr_tpu/ops/fused_csgu.py:26"),
        "K4": ("group_attend_anc", "tailored_avsr_tpu_torch/csrc/group_attend.cu",
               "tailored_avsr_tpu/ops/group_attend.py:47"),
        # K5 in its step form: every cached layer's columns of a beam step in one launch
        "K5": ("write_step_columns", "tailored_avsr_tpu_torch/csrc/cache_update.cu",
               "tailored_avsr_tpu/ops/cache_update.py:55"),
        "K5'": ("write_cache_column", "tailored_avsr_tpu_torch/csrc/cache_update.cu",
                "tailored_avsr_tpu/ops/cache_update.py:46"),
        "K6": ("group_attend_anc_q", "tailored_avsr_tpu_torch/csrc/group_attend.cu",
               "tailored_avsr_tpu/ops/group_attend.py:99"),
        "P1": ("stream_abs_sum", "tailored_avsr_tpu_torch/csrc/stream_probe.cu",
               "scripts/bench_int8_stream.py:34"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[key], **phases[key, "bf16"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
