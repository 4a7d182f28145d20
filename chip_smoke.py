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
   K2 and K1, bf16 (tensor cores) and f32 (exact f32 on the CUDA cores),
   also at T = 1, 63, 64, 65, 100, 128, 499 and 500 (K2 with and without
   bias; f32 K2 also at the eval batch's B=4, T=500 with bias, timed), one
   utterance fully masked (exactly 0); beside K1 in both types at T = 100
   and 500 the bias route it replaces, timed as a yardstick:
   rel_shift(q_rel . pos^T) built and streamed through K2, or through
   ``scaled_dot_product_attention`` (in f32 its memory-efficient backend
   runs 3xTF32 on the tensor cores: timed, its error printed, not
   gated); K4 (group
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
   ``scripts/bench_int8_stream.py``; K3 (the cgMLP gate) over an edge
   sweep (T = 1, 15, 16, 17, 31, 100, 500; k = 3 and 31; B = 1 and 32) and
   timed at request (a) (the kernels line) and request (b)'s shape. Then
   the visual stem (``visual_stem_phase``; its own JSON line): at 24 x 500
   frames of 88 x 88 its error against the f32 plain version no larger
   than the bf16 module chain's, at 512 x 100 each element within half a
   bf16 step of the f32 plain version (computed a slice of the batch at a
   time), an edge sweep, and times at the greedy and beam shapes beside
   its bound and the module chain.
5. Greedy path: the flagship serving model (the ``_tpu.yaml`` values, 12
   blocks, 256-d, random weights from a seed) with ``use_flash`` and
   ``use_fused_csgu`` on serves two requests through
   ``Speech2Text.greedy``: 32 x 4 s (encoder T = 100, K2 runs) and
   24 x 20 s (T = 500, K1 runs), in bf16 and in f32 (the f32 request (b)
   must launch K1 19 times; each bf16 call launches the visual stem kernel
   once, each f32 call never). Each f32 request is served again on the eager
   path (kernels off): the greedy ids must be identical and the CTC
   log-probs agree within 1e-3. Launch counts of K1-K3 over this path must
   be > 0. Then request (b) runs warm (five calls in bf16, two in f32;
   median wall printed) and once under ``torch.profiler`` in each type: the
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
   ``mem_dtype: int8``, the same five calls; K6 and the step write must
   launch (once a step) and K4 must not, nor K6 in the plain twin. The f32
   K6 run is held to the plain twin's envelope (``envelope_gate``: the twin
   un-noised and under three seeded relative noises of 1e-6 on what it
   quantises; stable utterances keep the fixed rule, the others must give
   some plain run's 1-best or 2-best at its score, or lie at the 1-best
   score of a plain run whose top two tie), on request (a) and on a
   second request; the earlier fixed gate (scores within 2e-2, a differing
   1-best only as a near-tied swap) is printed beside it for K6 and each
   noised run. On request (a) two planted faults in the plain twin (value
   scales 5 % high; feature 0 of every step's keys zeroed) must fall beyond
   the envelope, and a held-out noise seed is read through it (printed, not
   gated). The share of utterances whose int8 1-best equals the exact bf16
   run's is printed, not gated.
8. Serving modes (``serving_modes_phase``), the same model and LM at
   request (a), counts set to 0 first: K4's two new type pairs (bf16
   queries over an f32 cache, f32 queries over a bf16 cache) against the
   plain version at the decoder's and the LM's shapes; the beam with
   ``cache_dtype: float32`` under bf16 and ``bfloat16`` under f32, K4 on
   every cached layer of every step and the step write once a step, the
   f32 run held to the plain twin's envelope (``envelope_gate``, the twin
   un-noised and under NOISE_SEEDS on the columns the bf16 cache rounds);
   ``cache_protocol: append`` and ``cache_segments: 4`` (f32 1-best ids
   equal to the ancestry protocol's, scores within 1e-3); the
   time-synchronous beam with decoder and LM rescoring; n-gram fusion
   (a seeded character trigram ARPA written to a temporary directory:
   ``full``, ``part``, in the time-sync beam); qint8 weights (the
   quantised leaves a quarter of their f32 bytes on the card); each f32
   mode's ids equal to the eager path's; the full-prefix LM at
   ``ctc_weight: 1.0`` (8 x 4 s, one call); ``device_normalize`` with
   ``stream`` over four batches, equal to four ``nbest`` calls, with the
   profiled overlap of its host-to-device copies with compute; last, the
   bf16 model over f32 caches with its weights and the LM's quantised
   (``qint8``, then ``bfloat16`` storage), K4 on every cached layer (each
   model's first on the bf16-query pair), held to its plain twin's
   envelope. Every call's launches are asserted exactly; each mode's first
   call's wall is printed (its warm walls are the benchmark's to take).
9. Train path (``flagship_train_phase``, ``card_vs_cpu_phase``,
   ``learning_canary``): the flagship at full width with
   its training settings (4 x 20 s of seeded int16 audio and uint8 video,
   250-300 characters of seeded text an utterance, Adam + Noam, accum_grad
   16) takes 32 micro-steps (two updates) in bf16 autocast over f32 master
   weights: losses and accumulated gradients finite, parameters and
   BatchNorm statistics moved, and no kernel launched by a train step
   (counts set to 0 before, read after). It prints the median warm
   micro-step wall time and its spread, seconds of speech trained per wall
   second and ``torch.cuda.max_memory_allocated``. The train state saved
   after update 1 is loaded into a fresh model, which runs update 2: its
   losses and the eval loss after it must equal the uninterrupted run's
   (``RESUME_RTOL``); one of its micro-steps runs under ``torch.profiler``
   (device busy time, idle share, device ms by kind of kernel). One eval
   step (f32) on the trained weights must launch
   K1 or K2 and K3, and its greedy ids equal those of the eager eval step on
   the same weights. Then f32 on the card against f32 on the CPU (2 encoder
   and 1 decoder layers at 256-d, 2 x 2 s, every rate 0): loss and gradient
   norm within ``CARD_VS_CPU_RTOL``. Then a learning canary: the 64-d tiny
   model memorises 4 tone-spelled utterances to greedy CER below the CPU
   canary's 20 %.
10. Branchformer family (``branchformer_phase``), the paper's own models at
   full width (12 blocks, 256-d, 6 decoder layers; seeded weights;
   ``use_flash`` and ``use_fused_csgu`` on), each path with its counts set
   to 0 before it and read after: the ASR Branchformer
   (``configs/ASR/branchformer_transformer+ctc_spanish.yaml``, int16
   audio) serves greedy requests (a) 32 x 4 s (T = 99: K2 and K3 12 times a
   call) and (b) 24 x 20 s (T = 499: K1 and K3 12 times a call), then the
   beam + LM at (a) (beam 10, ctc 0.1, lm 0.4: the flagship beam phase's,
   not the config's beam 30), f32 through K4 held to the plain group attend
   (1-best equal, scores within 1e-3); the VSR Branchformer (uint8 lip
   crops, 100 frames) and the conventional AVSR encoder (two Branchformer
   stacks: K2 and K3 24 times a call) serve greedy request (a). Each
   greedy request in f32 runs through the kernels and on the eager path of
   the same engine: ids identical, CTC log-probs within 1e-3, every
   layer's learned branch weights within 1e-4. bf16 walls (five warm
   calls) and one profiled call each. Then 16 ASR training micro-steps at
   the config's settings (4 x 20 s, accum_grad 16: one update) in bf16
   autocast: no kernel launched, finite, every parameter moved.
11. Mask-CTC and the transducer (``maskctc_transducer_phase``), at full
   width with seeded weights and the encoder kernels on, every call's
   launches asserted exactly: Mask-CTC on the tailored AVSR encoder
   (``configs/AVSR/tailored_maskctc_spanish.yaml``) serves request (a)
   32 x 4 s through ``Speech2Text.nbest`` (K2 19, K3 5 a call, 10 MLM
   rounds with no kernel), bf16 twice and f32; the f32 call gives the
   eager path's ids, CTC log-probs within 1e-3; the tokens masked before
   the rounds are printed. The RNN-T transducer on the ASR Branchformer
   (``configs/ASR/branchformer_transducer_spanish.yaml``) serves greedy
   (beam 1) requests (a) (K2 12, K3 12) and (b) 24 x 20 s (K1 12, K3 12),
   f32 ids equal to the eager path's, then the config's beam 30 at (a)
   (ALSD, 198 steps), the f32 1-best held to the eager run by
   ``envelope_gate`` (scores within 1e-3; a near-tied swap of the top two
   passes with its margin printed). bf16 walls (five warm calls) and a
   profiled call of each path; then the f32 transducer with
   ``quantize_dtype: bfloat16`` at the config's ``quantize_min_size``:
   greedy ids equal to the eager path's on the same quantised weights, the
   beam's 1-best held to it by ``envelope_gate``. Then 16 training
   micro-steps of each config (4 x 20 s, accum_grad 16: one update) in
   bf16 autocast: no kernel, finite, every parameter moved, peak memory
   printed.
12. The rest of the recipe (``recipe_phase``), counts set to 0 first: the
   16-layer LM trained by ``lm_main.main`` (2 epochs over 256 seeded
   Spanish lines, batch 32: losses finite and falling, the average
   written; step walls and peak memory), then served from its averaged
   ``.pth`` beside the flagship (f32 beam 10 at request (a): K4 on 22
   layers of every step, the step write once a step, 1-best held to the
   plain group attend); the flagship micro-step at 4 x 20 s with and
   without ``remat`` (loss within 1e-5, gradients' relative L2 gap within
   1e-3, BatchNorm statistics equal, lower peak memory; walls and peaks,
   and both peaks at 16 x 20 s); ``init: xavier_uniform`` and two
   micro-steps; the fusion weights of ``study_adaptive_fusion`` at (b)
   (K1, K3) and (a) (K2, K3), masks none and audio, bf16 and f32, against
   the plain path (``FUSION_TOL``); ``get_val_accs`` over two seeded
   checkpoints on a synthetic split and ``average_model --val-accs`` (the
   mean of the two); ``compute_flops`` at (a) and (b).
13. The encoders on the Branchformer base (``encoder_variants_phase``, run
   after 11 and before 12), at the repo's widths (12 blocks, 256-d, 4 heads, 2048 FFN units, k = 31),
   seeded weights, the encoder kernels on, only the encoder keys named set
   in the repo's YAML, counts set to 0 first, every call's launches
   asserted exactly (``_encoder_kernels``): the Conformer ASR greedy at
   (a) 32 x 4 s (K2 12) and (b) 24 x 20 s (K1 12), then its beam + the
   16-layer LM at (a), f32 through K4 held to the plain group attend; the
   Conformer with ``rel_pos_type: legacy`` at (b) (K2 12: the legacy bias
   never reaches K1); the E-Branchformer (``concat``, its merge conv) at
   (a) (K2 12, K3 12); the conventional AVSR with Conformer stacks at (a)
   (K2 24); the Transformer (``abs_pos``, ``selfattn``, ReLU) at (a) (no
   kernel, as in JAX); the flagship with interCTC taps after layers 4 and
   8 and audio-visual conditioning at (a) (K2 19, K3 5). Each greedy
   request in f32 through the kernels and on the eager path: ids
   identical, CTC log-probs within 1e-3. bf16: the first call's wall,
   three warm calls (median) and a profiled one. Then two bf16 train
   micro-steps (4 x 20 s) of the Conformer ASR and of the interCTC
   flagship (``interctc_weight`` 0.3): no kernel, stats (the taps' CTC
   losses among them) and accumulated gradients finite, every BatchNorm's
   running statistics moved; walls and peak memory printed.
14. The other attention decoders and the RNN encoders
   (``decoder_variants_phase``, run after 13 and before 12), seeded
   weights, counts set to 0 first, every call's launches asserted
   exactly: the flagship with each of ``sim_t``, ``lightweight_conv``,
   ``dynamic_conv``, ``lightweight_conv2d``, ``dynamic_conv2d`` (from its
   decoder_conf: 6 blocks, 4 heads, 2048 units), ``rnn`` and ``s4`` (the
   registry's defaults) and the 16-layer LM through the full-prefix beam
   10 at 8 x 4 s (K2 19, K3 5 a call; no K4, no step write: no cache
   step, as in JAX): the first call (its beam steps counted) and a
   profiled one, no warm call, in bf16 (the four conv decoders: the f32
   first call alone, which is also the gate's kernel side); f32
   through the kernels and on the eager path, n-best ids equal and scores
   within 1e-3. Mask-CTC over the Sim-T MLM decoder at
   (a) (K2 19, K3 5) and (b) (K1 19, K3 5), f32 ids equal to the eager
   path's; the RNN and VGG-RNN ASR encoders (the registry's 4
   bidirectional 320-unit layers) greedy at (a) and the VGG-RNN with the
   LSTM decoder through the beam + LM at 8 x 4 s (no kernel, as in JAX),
   f32 held to the eager path, each bf16 engine's encoder handing f32 on
   (as flax's does); two bf16 micro-steps (4 x 20 s) of the
   flagship with Sim-T and of the VGG-RNN + LSTM ASR: no kernel, finite;
   walls and peak memory printed. Each path's record in the JSON line
   is keyed ``{choice}_decoder`` / ``{choice}_encoder``.
16. The input side, streaming and PIT (``input_side_streaming_phase``, run
   after 14 and before 12), at the ASR config's widths, seeded weights,
   counts set to 0 first: the ASR Branchformer with the fused frontend
   (log-mel + sliding window at hop 160), global MVN (the statistics of a
   seeded 16 x 4 s corpus) and linear pre- and post-encoders, then with utterance MVN
   ``norm_vars``, f32 greedy at (a) 32 x 4 s (K2 12, K3 12) and (b)
   24 x 20 s (K1 12, K3 12), ids equal to the eager path's, CTC log-probs
   within 1e-3; the contextual-block Transformer and Conformer encoders
   (block 40, hop 16) over 8 x 20 s fed to ``ContextualBlockStreamer`` in
   640 ms chunks (frames within 1e-4 of the offline encode, greedy ids
   equal; ms a chunk and the real-time factor), ``TimesyncStreamer`` at
   beam 10 and ``TransducerStreamer`` (the transducer config on the
   block Conformer) equal to their offline searches, no kernel launched;
   PIT on ``transformer_multispkr`` (12 shared layers, 2 x 2 speaker
   layers): two bf16 micro-steps at 4 x 20 s (finite, no kernel; walls
   and peak memory), the f32 loss with the references swapped within
   1e-6 relative, the card against the CPU within 1e-4.
17. Data and tensor parallelism (``parallel_phase``, last): two ranks
   spawned on cuda:0 over gloo (NCCL refuses two ranks on one card), each
   process counting its own launches: (a) the f32 beam 10 + LM over the
   ranks with ``data_parallel: true``, 4 x 4 s, two utterances a rank,
   greedy and 2-best ids equal to the same engine's single-process calls
   and scores within 1e-3, K2, K3, K4 and the step write launched in each
   rank; (b) the f32 micro-step of the flagship, rates 0, at global
   4 x 20 s: the all-reduced gradient within relative L2 1e-3 of the
   single-process step's, BatchNorm statistics within 1e-5 of each
   tensor's largest, the replicas bit-identical after the update; then
   one bf16 micro-step a rank (wall, peak memory) and the gradient's
   all-reduce alone; (c) the same f32 gates with ``model_parallel`` 2;
   then (d) the data-parallel f32 micro-step over a one-rank NCCL group
   in this process, held to (b)'s reference.
18. Prints one JSON line of train numbers, one of the Branchformer
   family's numbers, one of the Mask-CTC and transducer paths' numbers,
   one of the encoder variants' numbers, one of the decoder variants'
   numbers, one of the input side's and streamers', one of the parallel
   phase's, the seconds of each phase,
   one JSON line of per-kernel results (launches: K1-K3
   from the greedy path, K4, K5 (the step write) and K5' from the beam
   path, K6 from the int8 beam path; P1 counted over both beam paths,
   where no serving code may launch it; beside them the serving modes'
   launches and K4's mixed pairs' numbers, the train path's
   launches in its train steps and in its eval step, each
   Branchformer path's, each Mask-CTC and transducer path's, the encoder
   and decoder variants', the input side's, the recipe phase's and each
   rank's of the parallel phase; K4's library yardstick at the
   decoder's shape and K5's at one layer beside them), one of the recipe's
   numbers before it, then the result line ``{"ok": true, "device":
   {...}}`` last.

Any failed phase raises, so the run exits non-zero and prints no result line.
Nothing here imports JAX.

Four measurement modes, one card each:

    python3 chip_smoke.py --ab DIR          # DIR: a git archive of another commit
    python3 chip_smoke.py --heldout SEED ...
    python3 chip_smoke.py --k3-phases
    python3 chip_smoke.py --attention-phases

``--ab`` runs ``ab_measure`` (bf16 K3 at both request shapes, K1 at (b)
and K2 at (a) in f32 and bf16, L2-cold, and the profiled device busy time
of greedy requests (a) and (b) in bf16 and (b) in f32) on the package
under DIR and on this checkout's, in the order DIR, this, this, DIR, one
process each. ``--heldout`` reads the int8 plain twin under each
given noise seed through the envelope of both requests. ``--k3-phases``
times K3 with its phases taken out one after another (``K3_PHASE_CUTS``),
``--attention-phases`` f32 K1 and K2 (``ATTENTION_F32_PHASE_CUTS``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

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
    print(f"    kernel {ms:.4f} ms, plain {'not measured' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
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
    results, keyed (kernel, "bf16" or "f32"), at the main-path shape: bf16
    is the type the ``_tpu`` flagship serves in, f32 that of the other
    configs (f32 K2 also at the eval batch's shape)."""
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

        eval_batch = _k2_edges(fa, randn, gen, device, dtype)
        if eval_batch:
            results["K2 eval batch", tag] = eval_batch
        _k1_edges(fa, randn, gen, device, dtype)

        # K3: fused cgMLP gate, request (a) shapes (the kernels line), (b)'s timed beside it
        results["K3", tag] = _k3_phase(fc, randn, dtype, tag)
    return results


def _csgu_args(randn, b, t, u, ks, dtype) -> tuple:
    x = randn(b, t, u, dtype=dtype)
    gamma = 1.0 + randn(u // 2, dtype=dtype, scale=0.1)
    beta = randn(u // 2, dtype=dtype, scale=0.1)
    w = randn(ks, 1, u // 2, dtype=dtype, scale=ks ** -0.5)
    cb = randn(u // 2, dtype=dtype, scale=0.1)
    return x, gamma, beta, w, cb


def _csgu_bound(args, out) -> tuple:
    """K3's bound: its inputs and output once over the memory rate, or its
    operations per gated element (LayerNorm ~8, the k-tap conv 2k, bias
    and gate) over the f32 CUDA-core rate (67 TFLOP/s) in either type: no
    tensor core computes a depthwise conv. Bytes bound it at both request
    shapes (bf16 (a) 5.9 us against 3.5 us of operations, (b) 22.0 against
    13.2)."""
    b, t, u = args[0].shape
    return _bound(_nbytes(*args, out), b * t * (u // 2) * (2 * args[3].shape[0] + 10), torch.float32)


def _k3_phase(fc, randn, dtype, tag) -> dict:
    """K3 against its plain version over an edge sweep (T across the
    32-row tile, k = 3 through the generic conv and 31 through the
    register window, B = 1 and 32), then L2-cold times at request (a)
    (returned: the kernels line) and (b) (printed), each with its bound."""
    u = 2048
    for ks in (3, 31):
        for b in (1, 32):
            worst = 0.0
            for t in (1, 15, 16, 17, 31, 100, 500):
                args = _csgu_args(randn, b, t, u, ks, dtype)
                worst = max(worst, _compare(f"K3 fused_csgu {tag} B={b} T={t} U={u} k={ks}", "csgu",
                                            fc.fused_csgu(*args), fc.fused_csgu_plain(*args), show=False))
            print(f"  K3 fused_csgu {tag} edge sweep B={b} k={ks}, T = 1, 15, 16, 17, 31, 100, 500: "
                  f"max_abs_err={worst:.3e} -> ok")
    results = {}
    for name, b, t in (("(a)", 32, 100), ("(b)", 24, 500)):
        args = _csgu_args(randn, b, t, u, 31, dtype)
        out = fc.fused_csgu(*args)
        err = _compare(f"K3 fused_csgu {tag} request {name} B={b} T={t} U={u} k=31", "csgu",
                       out, fc.fused_csgu_plain(*args))
        results[name] = _result(err, cold_time_ms(lambda: fc.fused_csgu(*args)),
                                cold_time_ms(lambda: fc.fused_csgu_plain(*args)), _csgu_bound(args, out))
    return results["(a)"]



def _stem_params(randn, gen, device) -> tuple:
    """A stem weight at its initialiser's scale and BatchNorm parameters
    and running statistics away from 1 and 0, in bf16."""
    weight = randn(64, 1, 5, 7, 7, dtype=torch.bfloat16, scale=(2 / 245) ** 0.5)
    var = (torch.rand(64, generator=gen, device=device) * 2.8 + 0.2).to(torch.bfloat16)
    return (weight, (1.0 + randn(64, dtype=torch.float32, scale=0.3)).to(torch.bfloat16),
            randn(64, dtype=torch.bfloat16, scale=0.3), randn(64, dtype=torch.bfloat16, scale=0.5), var)


def _stem_chain(video, weight, bn_w, bn_b, mean, var, eps, act):
    """The module chain the kernel replaces, in the video's type: cuDNN's
    conv, eval BatchNorm, the activation, ``max_pool3d``, the trunk's layout."""
    b, t = video.shape[:2]
    x = F.conv3d(video[:, None], weight, None, (1, 2, 2), (2, 3, 3))
    x = act(F.batch_norm(x, mean, var, bn_w, bn_b, False, 0.0, eps))
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    return x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])


# Tolerance of the stem's edge sweep against its plain version: both sum in
# f32 in other orders and round once to bf16, so they differ by at most one
# bf16 step (2^-7 relative), and by the sums' order (~1e-6 of the sum of
# |terms|, under 1e-3 at these magnitudes) where a value sits on a rounding
# boundary.
STEM_TOL = (1e-3, 2 ** -7)


def visual_stem_phase(device) -> dict:
    """The fused visual stem (``ops/visual_stem.py``). Gate: at the greedy
    cell's shape (24 x 500 frames of 88 x 88, swish), the kernel and the
    bf16 module chain it replaces (``_stem_chain``) against the f32 plain
    version on the same bf16-rounded video, weight and BatchNorm; the
    kernel's max and mean abs errors must be no larger than the chain's (it
    rounds once where the chain rounds three times), and each element within
    2^-8 |ref| (half a bf16 step: its one rounding) + 1e-3 (the sums'
    order). Then an edge sweep against the plain version (T = 1, 3, 7 with
    frames past both ends; 88 x 88 and 100 x 104 through the tensor map,
    13 x 11, 20 x 17 and 30 x 200 element by element; one, two and three
    units of 48 conv columns; each activation). At the beam cell's shape
    (512 x 100 frames, where each persistent block walks more frames) each
    element within the same 2^-8 |ref| + 1e-3 of the f32 plain version,
    computed 32 utterances at a time. Then L2-cold times at both shapes
    beside the bound, the plain version (greedy shape only: in f32 at the
    beam shape at once it needs ~76 GB) and the chain (``library_ms``).
    Returns {shape: result}."""
    from tailored_avsr_tpu_torch.ops import visual_stem as vs

    gen = torch.Generator(device=device).manual_seed(7)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    params, eps = _stem_params(randn, gen, device), 1e-5
    for act in vs.ACTIVATIONS:
        for shape in ((2, 1, 88, 88), (3, 3, 13, 11), (2, 7, 20, 17), (1, 4, 100, 104), (1, 2, 30, 200)):
            video = randn(*shape, dtype=torch.bfloat16)
            got = vs.visual_stem(video, *params, eps, act)
            want = vs.visual_stem_plain(video, *params, eps, act)
            diff = (got.float() - want.float()).abs()
            excess = float((diff - STEM_TOL[1] * want.float().abs()).max())
            ok = got.shape == want.shape and bool(torch.isfinite(got.float()).all()) and excess <= STEM_TOL[0]
            print(f"  visual stem {act} {shape}: max_abs_err={float(diff.max()):.3e} against the plain "
                  f"version -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"visual stem {act} {shape}: kernel disagrees with its plain version")

    results = {}
    for name, (b, t) in (("greedy 24 x 500", (24, 500)), ("beam 512 x 100", (512, 100))):
        video = randn(b, t, 88, 88, dtype=torch.bfloat16)
        args = (video, *params, eps, "swish")
        out = vs.visual_stem(*args)
        err = None
        if b == 24:
            ref = vs.visual_stem_plain(video.float(), *(p.float() for p in params), eps, "swish")
            chain = _stem_chain(video, *params, eps, F.silu)
            errs = {}
            for what, got in (("kernel", out), ("module chain", chain)):
                d = (got.float() - ref).abs()
                errs[what] = (float(d.max()), float(d.mean()), float((d - 2 ** -8 * ref.abs()).max()))
                del d
            del ref, chain
            (k_max, k_mean, k_excess), (m_max, m_mean, _) = errs["kernel"], errs["module chain"]
            ok = bool(torch.isfinite(out.float()).all()) and k_max <= m_max and k_mean <= m_mean and k_excess <= 1e-3
            print(f"  visual stem {name}, against the f32 plain version: kernel max {k_max:.3e} mean {k_mean:.3e} "
                  f"(beyond 2^-8 |ref|: {k_excess:.3e}, tol 1e-3), bf16 module chain max {m_max:.3e} mean "
                  f"{m_mean:.3e} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"visual stem {name}: the kernel's error exceeds the module chain's")
            err = k_max
        else:  # each frame's output depends on its own utterance only: the f32 reference a slice at a time
            k_max, k_excess, step = 0.0, -float("inf"), 32
            for i in range(0, b, step):
                ref = vs.visual_stem_plain(video[i:i + step].float(), *(p.float() for p in params), eps, "swish")
                d = (out[i * t:(i + step) * t].float() - ref).abs()
                k_max, k_excess = max(k_max, float(d.max())), max(k_excess, float((d - 2 ** -8 * ref.abs()).max()))
                del ref, d
            ok = bool(torch.isfinite(out.float()).all()) and k_excess <= 1e-3
            print(f"  visual stem {name}, against the f32 plain version {step} utterances at a time: kernel max "
                  f"{k_max:.3e} (beyond 2^-8 |ref|: {k_excess:.3e}, tol 1e-3) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"visual stem {name}: the kernel disagrees with the f32 plain version")
            err = k_max
        flops = 2 * 64 * 245 * b * t * 44 * 44
        results[name] = _result(
            err, cold_time_ms(lambda: vs.visual_stem(*args)),
            cold_time_ms(lambda: vs.visual_stem_plain(*args)) if b == 24 else None,
            _bound(_nbytes(video, params[0], out), flops, torch.bfloat16),
            cold_time_ms(lambda: _stem_chain(video, *params, eps, F.silu)))
        results[name]["launches_per_call"] = 1
        del video, out
        torch.cuda.empty_cache()
    return results

# T across the tile edges of both forms (bf16: 16 rows, 16 and 64 keys; f32:
# 32-row warps, 32-key halves, 64-key tiles, 128-row blocks) and request
# (b)'s T = 499 (the ASR and transducer encoders) and 500 (the flagship)
EDGE_T = (1, 63, 64, 65, 100, 128, 499, 500)


def _k2_edges(fa, randn, gen, device, dtype) -> dict:
    """K2 at T across its tile edges (``EDGE_T``), with and without bias, one
    utterance fully masked (exactly 0) and ragged lengths elsewhere; times
    at T = 500 (B=24) beside the one-call yardstick, and in f32 at the eval
    batch's B=4, T=500 with bias (printed; that one returned)."""
    from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

    h, dk = 4, 64
    tag = "f32" if dtype == torch.float32 else "bf16"
    shapes = [(24 if t == 500 else 8, t) for t in EDGE_T]
    if dtype == torch.float32:
        shapes.append((4, 500))
    eval_batch = {}
    for b, t in shapes:
        q, k, v = (randn(b, h, t, dk, dtype=dtype) for _ in range(3))
        bias = randn(b, h, t, t, dtype=dtype, scale=4.0)
        mask = _lengths_mask(gen, b, t, device)
        mask[1] = False
        for bname, bb in (("bias", bias), ("no bias", None)):
            if b == 4 and bb is None:
                continue
            got = fa.flash_attention(q, k, v, bb, mask)
            err = _compare(f"K2 flash_attention {bname} {tag} B={b} H={h} T={t} (utterance 1 fully masked)",
                           "attention", got, fa.flash_attention_plain(q, k, v, bb, mask))
            if bool(got[1].abs().max() != 0):
                raise AssertionError(f"K2 {tag} B={b} T={t}: a fully masked utterance must give exactly 0")
            if t == 500:
                merged = torch.zeros((b, 1, 1, t), dtype=dtype, device=device).masked_fill(
                    ~mask[:, None, None, :], MASK_MIN)
                if bb is not None:
                    merged = merged + bb / dk ** 0.5
                args = (q, k, v, bb, mask)
                r = _result(err, cold_time_ms(lambda: fa.flash_attention(*args)),
                            cold_time_ms(lambda: fa.flash_attention_plain(*args)),
                            _bound(_nbytes(*args, got), 4 * b * h * t * t * dk, dtype),
                            cold_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=merged)))
                if b == 4:
                    eval_batch = r
    return eval_batch


def _k1_edges(fa, randn, gen, device, dtype) -> None:
    """K1 at T across its tile edges (``EDGE_T``), one utterance fully masked
    (exactly 0) and ragged lengths elsewhere. At T = 100 (request (a)'s
    shape) and T = 500 it is timed beside the bias route it replaces
    (printed as a yardstick, not in the line): rel_shift(q_rel . pos^T)
    materialised and streamed through K2, as ``ops/attention.py`` does
    below its 32 MiB switch, or through ``scaled_dot_product_attention``."""
    from tailored_avsr_tpu_torch.ops.attention import rel_shift
    from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

    h, dk = 4, 64
    tag = "f32" if dtype == torch.float32 else "bf16"
    for t in EDGE_T:
        b = {100: 32, 500: 24}.get(t, 8)
        q, k, v, qr = (randn(b, h, t, dk, dtype=dtype) for _ in range(4))
        pos = randn(h, 2 * t - 1, dk, dtype=dtype)
        mask = _lengths_mask(gen, b, t, device)
        mask[1] = False
        args = (q, k, v, qr, pos, mask)
        got = fa.flash_attention_relpos(*args)
        _compare(f"K1 flash_attention_relpos {tag} B={b} H={h} T={t} (utterance 1 fully masked)",
                 "attention", got, fa.flash_attention_relpos_plain(*args))
        if bool(got[1].abs().max() != 0):
            raise AssertionError(f"K1 {tag} T={t}: a fully masked utterance must give exactly 0")
        if t in (100, 500):
            def bias():
                return rel_shift(qr @ pos.transpose(-2, -1)).contiguous()

            def via_k2():
                return fa.flash_attention(q, k, v, bias(), mask)

            def via_sdpa():
                merged = torch.zeros((b, 1, 1, t), dtype=dtype, device=device).masked_fill(
                    ~mask[:, None, None, :], MASK_MIN) + bias() / dk ** 0.5
                return F.scaled_dot_product_attention(q, k, v, attn_mask=merged)

            _compare(f"  bias route via K2, {tag} T={t}", "attention", via_k2(),
                     fa.flash_attention_relpos_plain(*args))
            _result(0.0, cold_time_ms(lambda: fa.flash_attention_relpos(*args)),
                    cold_time_ms(lambda: fa.flash_attention_relpos_plain(*args)),
                    _bound(_nbytes(*args, got), 6 * b * h * t * t * dk, dtype))
            print(f"    K1 yardstick {tag} T={t}: bias route, materialised (B, H, T, T) bias + K2 "
                  f"{cold_time_ms(via_k2):.4f} ms, + scaled_dot_product_attention "
                  f"{cold_time_ms(via_sdpa):.4f} ms, the bias alone {cold_time_ms(bias):.4f} ms "
                  f"({b * h * t * t * got.element_size() / 2 ** 20:.1f} MiB)")


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
                library_ms = (_k4_library_ms(*args, got, f"{tag} {shape}")
                              if pos == 53 and width is None else None)
                r4 = _result(err, cold_time_ms(lambda: ga.group_attend_anc(*args, width=width)),
                             cold_time_ms(lambda: ga.group_attend_anc_plain(*args, width=width)), bound,
                             library_ms)
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
                elif pos == 53 and width is None:  # the decoder's shape
                    results["K4 decoder", tag] = r4
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
            col = min(pos, lc - 1)

            def library_kv():  # the yardstick: indexed assignment of both columns, cast included
                kc[:, :, :, col] = kcol
                vc[:, :, :, col] = vcol

            r5 = _result(err, cold_time_ms(lambda: cu.write_cache_columns_kv(kc, vc, kcol, vcol, pos)),
                         cold_time_ms(lambda: cu.write_cache_columns_kv_plain(kc, vc, kcol, vcol, pos)),
                         _bound(2 * col_bytes, 0, torch.float32), cold_time_ms(library_kv))
            print(f"  K5' write_cache_column {tag} pos={pos}: max_abs_err={err1:.3e} tol=0 "
                  f"(bit-exact) -> {'ok' if same1 else 'FAIL'}")

            def library():  # the one-call yardstick: indexed assignment, cast included
                kc[:, :, :, col] = kcol

            r5p = _result(err1, cold_time_ms(lambda: cu.write_cache_column(kc, kcol, pos)),
                          cold_time_ms(lambda: cu.write_cache_column_plain(kc, kcol, pos)),
                          _bound(col_bytes, 0, torch.float32), cold_time_ms(library))
            if not (same and same1):
                raise AssertionError(f"K5/K5' disagree with the plain write ({tag}, pos {pos})")
            if cache_dtype == torch.bfloat16 and pos == 57:
                results["K5'", "bf16"], results["K5 layer", "bf16"] = r5p, r5
    results["K5", "bf16"] = _step_write_phase(cu, gen, device)
    return results


def _k4_library_ms(k, v, q, k_new, v_new, anc, pos: int, want, shape: str) -> float:
    """K4's one-call yardstick, L2-cold: ``scaled_dot_product_attention``
    of the (B, H, K, dk) queries over the group cache flattened to (B, H,
    K*Lc, dk), the step's own column written first into column pos-1 of
    each query's own slot (a column K4 never reads), and the ancestry test
    ``anc[i, t] == j and t < pos-1`` (or the own column) as a boolean
    mask; its output held to K4's by K4's tolerance."""
    b, h, km, lc, dk = k.shape
    kf, vf = k.clone(), v.clone()
    kf[:, :, :, pos - 1], vf[:, :, :, pos - 1] = k_new, v_new
    t, j = torch.arange(lc, device=k.device), torch.arange(km, device=k.device)
    ancestry = (anc.long()[:, :, None, :] == j[None, None, :, None]) & (t < pos - 1)  # (B, i, j, t)
    own = (j[:, None, None] == j[None, :, None]) & (t == pos - 1)
    mask = (ancestry | own[None]).reshape(b, 1, km, km * lc)
    kf, vf = kf.reshape(b, h, km * lc, dk), vf.reshape(b, h, km * lc, dk)

    def library():
        return F.scaled_dot_product_attention(q, kf, vf, attn_mask=mask)

    _compare(f"K4 library yardstick (scaled_dot_product_attention, ancestry mask) {shape}", "group_attend",
             library(), want)
    return cold_time_ms(library)


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
        if hasattr(w, "combines"):
            w.combines = 0
        if hasattr(w, "pairs"):
            w.pairs.clear()


def _serve(engine, name: str, batch: dict) -> list:
    """One request through ``Speech2Text.greedy``; prints its wall time (the
    transcripts are on the host when greedy returns)."""
    from tailored_avsr_tpu_torch.ops.visual_stem import visual_stem

    before, stem = _counts(), visual_stem.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = engine.greedy(batch)
    wall = time.perf_counter() - t0
    after = _counts()
    launched = {k: after[k] - before[k] for k in ("K1", "K2", "K3")}
    launched["stem"] = visual_stem.launches - stem
    if launched["stem"] != int(engine.dtype == torch.bfloat16):
        raise AssertionError(f"{name}: the visual stem kernel launched {launched['stem']} times; a bf16 call "
                             "launches it once, an f32 call never")
    print(f"  {name}: {wall * 1e3:.1f} ms wall, launches {launched}")
    if len(hyps) != _utterances(batch):
        raise AssertionError(f"{name}: {len(hyps)} transcripts for {_utterances(batch)} utterances")
    return hyps


def _utterances(batch: dict) -> int:
    return len(batch["audio_lengths" if "audio_lengths" in batch else "speech_lengths"])


def _speech_seconds(batch: dict) -> float:
    """Seconds of speech in a request: audio samples at 16 kHz, or (a VSR
    request) lip frames at 25 fps."""
    if "audio_lengths" in batch:
        return float(np.sum(batch["audio_lengths"])) / 16000
    return float(np.sum(batch["speech_lengths"])) / (16000 if batch["speech"].ndim == 2 else 25)


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
    return call_profile(lambda: engine.greedy(batch), name, repeats)


def call_profile(call, name: str, repeats: int = 5, host_events: bool = True) -> dict:
    """``greedy_profile`` of any serving call (one that returns host data);
    without ``host_events`` the profiler records the device's events alone
    (a call of tens of thousands of launches takes it tens of seconds to
    sum otherwise)."""
    walls = _walls(call, repeats)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_events:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies, sets); a CPU op's device
    # time repeats its kernels' and is not summed
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    flash = sum(e.self_device_time_total for e in events if "flash_attention" in e.key) / 1e3
    out = {"median_wall_ms": float(np.median(walls))} if walls else {}  # no warm call: no median
    out.update({"profiled_wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                "flash_ms": flash})
    warm = ""
    if walls:
        warm = f"warm wall ms {', '.join(f'{w:.1f}' for w in walls)} (median {out['median_wall_ms']:.1f}); "
    print(f"  {name}: {warm}profiled call: device busy {busy:.2f} ms of {wall:.2f} ms wall (idle share "
          f"{out['idle_share']:.3f}), flash-attention kernels {flash:.2f} ms")
    return out


def serve_phase(device) -> dict:
    """The flagship serving path with the kernels, then held against the
    eager path on the same weights (f32 requests (a) and (b)); returns the
    main path's launch counts. Request (b), where K1 runs, is profiled in
    bf16 and f32 after the counted calls."""
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
    before = _counts()["K1"]
    _serve(f32, "f32 request (b) 24 x 20 s, T=500 (first call)", req_b)
    if _counts()["K1"] - before != 19:
        raise AssertionError(f"f32 request (b) launched K1 {_counts()['K1'] - before} times, not 19")
    _serve(f32, "f32 request (b) 24 x 20 s, T=500", req_b)
    launches = {k: v for k, v in _counts().items() if k in ("K1", "K2", "K3")}
    print(f"  launches over the greedy path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    print(f"  sample transcripts: (a) {hyp_a[0][:40]!r}  (b) {hyp_b[0][:40]!r}")
    greedy_profile(bf16, req_b, "bf16 request (b) 24 x 20 s")
    greedy_profile(f32, req_b, "f32 request (b) 24 x 20 s", repeats=2)

    print("eager path (kernels off) on the same weights:")
    f32_eager = engine("float32", False)
    for name, req in (("(a)", req_a), ("(b)", req_b)):
        ids_k, logp_k, lens_k = _ctc(f32, req)
        before = _counts()
        _serve(f32_eager, f"f32 eager request {name}", req)
        ids_e, logp_e, lens_e = _ctc(f32_eager, req)
        if _counts() != before:
            raise AssertionError("the eager path launched a kernel")
        valid = torch.arange(ids_k.shape[1], device=device)[None] < lens_k[:, None]
        same = bool(torch.equal(lens_k, lens_e)) and bool((ids_k == ids_e)[valid].all())
        dlogp = float((logp_k - logp_e).abs()[valid].max())
        print(f"  f32 request {name}: greedy ids identical: {same}; max |CTC log-prob diff| "
              f"{dlogp:.3e} (tol 1e-3)")
        if not same or dlogp > 1e-3:
            raise AssertionError(f"f32 kernel path disagrees with the eager path at request {name}")
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
    speech = _speech_seconds(batch)
    print(f"  {name}: {wall * 1e3:.1f} ms wall, {steps} beam steps, "
          f"{speech / wall:.1f} s of speech per wall second, launches K4 {k4} K5 (step write) {steps} K6 {k6}")
    if k5_layer or k5p or steps <= 0 or (k4 or k6) and k4 + k6 != layers * steps:
        raise AssertionError(f"{name}: the cache writes took {k5_layer} per-layer K5 and {k5p} K5' launches "
                             f"and {steps} step writes for {k4 + k6} group attends over {layers} layers")
    nbest = engine.beam_config.nbest
    if len(hyps) != _utterances(batch) or any(len(h) != nbest for h in hyps):
        raise AssertionError(f"{name}: expected {_utterances(batch)} n-best lists of {nbest}")
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
# close may trade places, or a hypothesis may lose its eos and end in a
# forced finish. Sound code does that too: the plain twin under relative
# noise of 1e-6 on what it quantises moves such utterances by as much. So
# K6 is held to the spread of sound code (``envelope_gate``): the plain twin
# un-noised and under NOISE_SEEDS. A wrong kernel moves scores by O(1).
# Readings: PERF.md.
SCORE_ATOL = {"K4": 1e-3, "K6": 2e-2}
NOISE_SEEDS = (0, 1, 2)  # the noises of the envelope's plain runs
HELD_OUT_SEED = 3  # a sound run the envelope has not seen: printed, not gated


def _score_tol(ref: float, atol: float) -> float:
    """|score difference| allowed against a score ``ref``: ``atol`` or 8 f32
    ulps of it, whichever is more."""
    return max(atol, 8 * float(np.spacing(np.float32(abs(ref)))))


def envelope_gate(hyp, plain_runs, atol: float) -> tuple:
    """The int8 beam gate, a pure function of n-best lists (per utterance
    [(text, tokens, ids, score), ...], best first, at least a 2-best).
    ``plain_runs``: the plain twin un-noised first, then under seeded
    noises. An utterance is stable when every plain run gives it the same
    1-best ids at 1-best scores within ``_score_tol`` of one another; there
    ``hyp`` must give the un-noised run's 1-best at its score, or swap the
    top two with it at those scores (a near tie). Elsewhere ``hyp``'s 1-best
    must be, at its score (within ``_score_tol``), the 1-best or 2-best of
    some plain run; or, where a plain run's top two are tied (within
    ``_score_tol``), it must lie at that run's 1-best score, whatever its
    ids: the order of a tie is not determined. A forced finish (about -1e9,
    where an f32 ulp is 64) ties the beam's hypotheses, and under noise the
    beam may end on one that no plain run lists. Returns (stable
    utterances, [(utterance, reason), ...] beyond the gate)."""
    stable, bad = 0, []
    for u, g in enumerate(hyp):
        runs = [p[u] for p in plain_runs]
        w, scores = runs[0], [r[0][3] for r in runs]
        if all(r[0][2] == w[0][2] for r in runs) and \
                max(scores) - min(scores) <= _score_tol(max(scores, key=abs), atol):
            stable += 1
            if g[0][2] == w[0][2]:
                if abs(g[0][3] - w[0][3]) > _score_tol(w[0][3], atol):
                    bad.append((u, f"stable, 1-best score {g[0][3]:.6f} against {w[0][3]:.6f}"))
            elif not (g[0][2] == w[1][2] and g[1][2] == w[0][2]
                      and abs(g[0][3] - w[1][3]) <= _score_tol(w[1][3], atol)
                      and abs(g[1][3] - w[0][3]) <= _score_tol(w[0][3], atol)):
                bad.append((u, f"stable, 1-best differs and is no near-tied swap ({g[0][3]:.6f}, "
                               f"plain {w[0][3]:.6f}, {w[1][3]:.6f})"))
        elif not any(g[0][2] == h[2] and abs(g[0][3] - h[3]) <= _score_tol(h[3], atol)
                     for r in runs for h in r[:2]) and \
                not any(abs(r[1][3] - r[0][3]) <= _score_tol(r[0][3], atol)
                        and abs(g[0][3] - r[0][3]) <= _score_tol(r[0][3], atol) for r in runs):
            bad.append((u, f"unstable, no plain run has its 1-best at its score {g[0][3]:.6f} (plain "
                           f"1-best scores {', '.join(f'{x:.6f}' for x in scores)})"))
    return stable, bad


def _read_envelope(hyp, plain_runs, what: str) -> int:
    """Print how ``hyp`` reads under ``envelope_gate``; returns the number
    of utterances beyond it."""
    stable, bad = envelope_gate(hyp, plain_runs, SCORE_ATOL["K6"])
    for u, reason in bad:
        print(f"    utterance {u}: {reason}")
    print(f"  {what} against the plain twin's envelope ({len(plain_runs)} runs): {stable}/{len(hyp)} "
          f"utterances stable, {len(bad)} beyond the gate")
    return len(bad)


def _plain_run(engine, req, what: str, noise_seed=None, fault=None) -> list:
    """The plain twin's n-best on ``req``: with ``noise_seed``, relative
    noise of 1e-6 (seeded) on everything it quantises (the memory K/V and
    each step's columns); with ``fault``, a planted bug of the size a real
    one makes: ``"value scale"`` takes every cached value scale 5 % high in
    the group attend, ``"key column"`` zeroes feature 0 of every step's key
    columns before they are quantised."""
    from tailored_avsr_tpu_torch import inference as inf_mod
    from tailored_avsr_tpu_torch.decode import beam_search as bs
    from tailored_avsr_tpu_torch.ops import group_attend as ga

    quantize, attend = bs.quantize_kv_column, ga.group_attend_anc_q_plain
    patches = []
    if noise_seed is not None:
        gen = torch.Generator(device=engine.device).manual_seed(noise_seed)

        def noisy(x):
            return quantize(x * (1 + 1e-6 * torch.randn(x.shape, generator=gen, device=x.device)))

        patches += [(bs, "quantize_kv_column", noisy), (inf_mod, "quantize_kv_column", noisy)]
        what += f", relative noise 1e-6 (seed {noise_seed}) on the quantiser's inputs"
    if fault == "value scale":
        patches.append((ga, "group_attend_anc_q_plain",
                        lambda k, ks, v, vs, *a, **kw: attend(k, ks, v, vs * 1.05, *a, **kw)))
    elif fault == "key column":
        calls = [0]

        def drop_key_feature(x):  # a step quantises its K, then its V, columns, layer by layer
            calls[0] += 1
            return quantize(x.index_fill(-1, torch.tensor([0], device=x.device), 0.0)
                            if calls[0] % 2 else x)

        patches.append((bs, "quantize_kv_column", drop_key_feature))
    if fault:
        what += f", planted fault: {fault}"
    with contextlib.ExitStack() as stack:
        for module, name, value in patches:
            stack.enter_context(mock.patch.object(module, name, value))
        return _nbest(engine, what, req)


def _against_plain(hyp, hyp_plain, kernel: str, what: str) -> int:
    """Print how ``hyp`` reads against ``hyp_plain`` under ``kernel``'s
    fixed gate (for K6 the earlier gate, printed beside the envelope);
    returns the number of utterances beyond it."""
    atol = SCORE_ATOL[kernel]

    def close(g, w):
        return abs(g[3] - w[3]) <= _score_tol(w[3], atol)

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


def _int8_gate(plain, req, hyp_f32, hyp_plain, name: str, plant: bool) -> None:
    """The f32 K6 beam on ``req`` held to the plain twin's envelope (the
    un-noised run and NOISE_SEEDS); the earlier fixed gate printed beside it
    for K6 and for each noised run; a held-out noise seed read through the
    envelope (printed, not gated); with ``plant``, each planted fault must
    fall beyond it."""
    _against_plain(hyp_f32, hyp_plain, "K6", f"f32 K6, {name} (fixed gate, printed)")
    runs = [hyp_plain]
    for seed in NOISE_SEEDS:
        runs.append(_plain_run(plain, req, f"f32, plain group attend, {name}", noise_seed=seed))
        _against_plain(runs[-1], hyp_plain, "K6", f"plain + noise seed {seed}, {name} (fixed gate, printed)")
    if _read_envelope(hyp_f32, runs, f"f32 K6, {name}"):
        raise AssertionError(f"f32 beam through K6 falls outside the plain twin's envelope ({name})")
    held = _plain_run(plain, req, f"f32, plain group attend, {name}", noise_seed=HELD_OUT_SEED)
    _read_envelope(held, runs, f"plain + held-out noise seed {HELD_OUT_SEED}, {name} (not gated)")
    if plant:
        for fault in ("value scale", "key column"):
            hyp = _plain_run(plain, req, f"f32, plain group attend, {name}", fault=fault)
            if not _read_envelope(hyp, runs, f"planted fault '{fault}', {name}"):
                raise AssertionError(f"the int8 gate let the planted fault '{fault}' through")


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
    if kernel == "K4":
        _held_against_plain(hyp_f32, hyp_plain, kernel)
    else:  # the envelope gate on request (a), planted faults there, and a second request
        _int8_gate(plain, req, hyp_f32, hyp_plain, "request (a)", plant=True)
        req2 = _request(3, 32, 4)
        hyp_f32_2 = _nbest(f32, "f32, request (a) seed 3", req2)
        hyp_plain_2 = _nbest(plain, "f32, plain group attend, request (a) seed 3", req2)
        _int8_gate(plain, req2, hyp_f32_2, hyp_plain_2, "request (a) seed 3", plant=False)

    phased = _beam_engine(device, "bfloat16", phase_widths=[0.25, 0.5], **inference_conf)
    same = _nbest(phased, "bf16, phase_widths [0.25, 0.5]", req) == hyp_bf16
    print(f"  bf16 phased n-best equal to the unphased run: {same}")
    if not same:
        raise AssertionError("phased widths changed the bf16 n-best")
    return launches, hyp_bf16


def heldout_main(seeds) -> int:
    """The plain twin of the int8 beam (f32, plain group attend) under
    held-out noise seeds, each read through the envelope of both requests
    (the un-noised run and NOISE_SEEDS): sound code the gate has not seen.
    Exits non-zero if one falls outside."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    plain = _beam_engine(device, "float32", fused_group_attend=False, nbest=2, cache_dtype="int8",
                         mem_dtype="int8")
    beyond = 0
    for name, req in (("request (a)", _request(1, 32, 4)), ("request (a) seed 3", _request(3, 32, 4))):
        runs = [_nbest(plain, f"f32, plain group attend, {name}", req)]
        runs += [_plain_run(plain, req, f"f32, plain group attend, {name}", noise_seed=s) for s in NOISE_SEEDS]
        for seed in seeds:
            held = _plain_run(plain, req, f"f32, plain group attend, {name}", noise_seed=seed)
            beyond += _read_envelope(held, runs, f"plain + held-out noise seed {seed}, {name}")
    print(f"held-out seeds {list(seeds)} on both requests: {beyond} utterances beyond the envelope")
    return int(beyond > 0)


# Phases of csrc/csgu.cu taken out one at a time, cumulatively, by editing a
# copy of the source (the kernel's output is then wrong; only its time is
# read): what each phase costs at the request shapes.
K3_PHASE_CUTS = (
    ("the conv", [("if (r < tt + KS - 1) {", "if (false) {")]),
    ("the statistics", [
        ("for (int r = warp; r < rows; r += CB / 32) {", "for (int r = warp; r < 0; r += CB / 32) {"),
        ("  if (tid < rows) {\n    float2 p[MAX_CLUSTER];", "  if (false) {\n    float2 p[MAX_CLUSTER];")]),
    ("the cluster barriers", [
        ("  cluster_arrive();  // the partials are written (release) ...\n"
         "  cluster_wait();    // ... and every block's are visible (acquire)", "  __syncthreads();"),
        ("  cluster_arrive();  // done reading the other blocks' shared memory; waited on at the end", ""),
        ("  cluster_wait();  // no block leaves while another may still read its partials", "")]),
)


# f32 K1 and K2 (``csrc/attention.cu``'s f32 template) with their phases
# taken out one after another: the rel-pos product, Q . K^T, P . V, the
# softmax's exponentials (with every product gone the compiler may fold
# more of the softmax), the next tile's loads. What is left: the first
# tile's loads, the barriers, the merge of the key halves and the stores.
ATTENTION_F32_PHASE_CUTS = (
    ("the rel-pos product", [
        ("        if constexpr (REL) {\n#pragma unroll\n          for (int a = 0; a < 8; ++a)\n",
         "        if constexpr (REL && MODE < 0) {\n#pragma unroll\n          for (int a = 0; a < 8; ++a)\n")]),
    ("Q . K^T", [("          for (int e = 0; e < 4; ++e) s[a][e] = dot4(s[a][e], qa[a], kc[e]);", "")]),
    ("P . V", [("for (int j4 = 0; j4 < n4; ++j4) {", "for (int j4 = 0; j4 < 0; ++j4) {")]),
    ("the exponentials", [("const float corr = ex2(m[a] - mx);", "const float corr = m[a] - mx;"),
                          ("s[a][e] == NEG ? 0.f : ex2(s[a][e] - mx);", "s[a][e] == NEG ? 0.f : s[a][e] - mx;")]),
    ("the tile loads", [("    if (kt + 1 < n_tiles) {\n      load_tile(kt + 1, st ^ 1);",
                         "    if (kt + 1 < n_tiles) {\n      if (MODE < 0) load_tile(kt + 1, st ^ 1);")]),
)


def _phase_libraries(source: str, cuts, tag: str) -> tuple:
    """``csrc/<source>`` and copies with ``cuts`` taken out one after
    another (each edit at its first match), each built by nvcc into its
    own library under build/phases; returns their names and paths."""
    from tailored_avsr_tpu_torch.kernels import build

    out_dir = os.path.join(ROOT, "build", "phases")
    os.makedirs(out_dir, exist_ok=True)
    src = (build.CSRC / source).read_text()
    names, paths, cmds = ["whole kernel"], [], []
    for what, _ in cuts:
        names.append(f"without {what}" if len(names) == 1 else f"{names[-1]}, {what}")
    for i in range(len(names)):
        text = src
        for _, edits in cuts[:i]:
            for old, new in edits:
                if old not in text:
                    raise AssertionError(f"{source} no longer holds {old!r}: update its phase cuts")
                text = text.replace(old, new, 1)
        path = os.path.join(out_dir, f"{tag}{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        paths.append(path[:-3] + ".so")
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o", paths[-1], path])
    build._run_all(cmds)
    return names, paths


def _phases_device():
    """The card, its name and power limit printed; None without one."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU", file=sys.stderr)
        return None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def k3_phases_main() -> int:
    """K3's L2-cold time at request (a) and (b) shapes, bf16 and f32, for
    the committed source and for copies with the conv, then also the
    statistics, then also the cluster barriers taken out (K3_PHASE_CUTS)."""
    import ctypes

    from tailored_avsr_tpu_torch.ops import fused_csgu as fc

    device = _phases_device()
    if device is None:
        return 1
    names, paths = _phase_libraries("csgu.cu", K3_PHASE_CUTS, "k3_")
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    cases = [(dtype, name, _csgu_args(randn, b, t, 2048, 31, dtype))
             for dtype in (torch.bfloat16, torch.float32) for name, b, t in (("a", 32, 100), ("b", 24, 500))]
    for i, (name, path) in enumerate(zip(names, paths)):
        fn = ctypes.CDLL(path).avsr_fused_csgu
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        row = {"k3": name}
        for dtype, req, args in cases:
            b, t, u = args[0].shape
            out = torch.empty(b, t, u // 2, dtype=dtype, device=device)

            def run():
                err = fn(*(a.data_ptr() for a in args), out.data_ptr(), b, t, u // 2, 31,
                         int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K3 ({name}) failed: CUDA error {err}")

            run()
            if i == 0:  # the whole kernel is held to its plain version
                _compare(f"K3 {name} {req} {dtype}", "csgu", out, fc.fused_csgu_plain(*args), show=False)
            row[f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_{req}_ms"] = cold_time_ms(run)
        print(json.dumps(row))
    return 0


def attention_phases_main() -> int:
    """f32 K1 at request (b) and K2 at (b) without bias and at (a) with and
    without, L2-cold, for the committed source and for copies with the
    phases of ATTENTION_F32_PHASE_CUTS taken out one after another."""
    import ctypes

    from tailored_avsr_tpu_torch.ops import flash_attention as fa

    device = _phases_device()
    if device is None:
        return 1
    names, paths = _phase_libraries("attention.cu", ATTENTION_F32_PHASE_CUTS, "attention_f32_")
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    h, dk, cases = 4, 64, []
    for name, mode, b, t in (("k1_b", 2, 24, 500), ("k2_b", 0, 24, 500), ("k2_a_bias", 1, 32, 100),
                             ("k2_a", 0, 32, 100)):
        q, k, v = (randn(b, h, t, dk) for _ in range(3))
        bias = randn(b, h, t, t, scale=4.0) if mode == 1 else None
        q_rel, pos = (randn(b, h, t, dk), randn(h, 2 * t - 1, dk)) if mode == 2 else (None, None)
        cases.append((name, mode, (q, k, v, bias, q_rel, pos, _lengths_mask(gen, b, t, device))))
    for i, (name, path) in enumerate(zip(names, paths)):
        fn = ctypes.CDLL(path).avsr_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        row = {"attention_f32": name}
        for case, mode, args in cases:
            b, _, t, _ = args[0].shape
            out = torch.empty_like(args[0])

            def run():
                err = fn(*(None if a is None else a.data_ptr() for a in args), out.data_ptr(), b, h, t, dk,
                         0, mode, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"f32 attention ({name}) failed: CUDA error {err}")

            run()
            if i == 0:  # the whole kernel is held to its plain version
                q, k, v, bias, q_rel, pos, mask = args
                want = (fa.flash_attention_relpos_plain(q, k, v, q_rel, pos, mask) if mode == 2
                        else fa.flash_attention_plain(q, k, v, bias, mask))
                _compare(f"f32 attention {case}", "attention", out, want, show=False)
            row[f"{case}_ms"] = cold_time_ms(run)
        print(json.dumps(row))
    return 0


def ab_measure(greedy: bool = True) -> None:
    """For whichever ``tailored_avsr_tpu_torch`` is first on ``sys.path``:
    bf16 K3's L2-cold time at request (a) and (b) shapes, K1's at (b) and
    K2's at (a) (with and without bias) in f32 and bf16 (inputs from seed
    0), then (``greedy``) the device busy time of one profiled greedy call
    of bf16 requests (a) and (b) and f32 request (b) (``greedy_profile``).
    One JSON line."""
    from tailored_avsr_tpu_torch.kernels import build
    from tailored_avsr_tpu_torch.ops import flash_attention as fa
    from tailored_avsr_tpu_torch.ops import fused_csgu as fc

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    build.load()
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    row = {"package": os.path.dirname(os.path.dirname(os.path.abspath(fc.__file__)))}
    for name, b, t in (("a", 32, 100), ("b", 24, 500)):
        args = _csgu_args(randn, b, t, 2048, 31, torch.bfloat16)
        row[f"k3_{name}_ms"] = cold_time_ms(lambda: fc.fused_csgu(*args))
    h, dk = 4, 64
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        b, t = 24, 500
        q, k, v, qr = (randn(b, h, t, dk, dtype=dtype) for _ in range(4))
        args = (q, k, v, qr, randn(h, 2 * t - 1, dk, dtype=dtype), _lengths_mask(gen, b, t, device))
        row[f"k1_b_{tag}_ms"] = cold_time_ms(lambda: fa.flash_attention_relpos(*args))
        b, t = 32, 100
        q, k, v = (randn(b, h, t, dk, dtype=dtype) for _ in range(3))
        bias, mask = randn(b, h, t, t, dtype=dtype, scale=4.0), _lengths_mask(gen, b, t, device)
        row[f"k2_a_bias_{tag}_ms"] = cold_time_ms(lambda: fa.flash_attention(q, k, v, bias, mask))
        row[f"k2_a_{tag}_ms"] = cold_time_ms(lambda: fa.flash_attention(q, k, v, None, mask))
    if greedy:
        for dtype, tag, names in (("bfloat16", "", ("a", "b")), ("float32", "_f32", ("b",))):
            engine = _greedy_engine(device, dtype, True)
            for name in names:
                req = _request(1, 32, 4) if name == "a" else _request(2, 24, 20)
                engine.greedy(req)
                prof = greedy_profile(engine, req, f"{dtype} request ({name})")
                row[f"greedy{tag}_{name}_busy_ms"], row[f"greedy{tag}_{name}_wall_ms"] = (
                    prof["device_busy_ms"], prof["median_wall_ms"])
    print(json.dumps(row))


def ab_main(parent: str, greedy: bool = True) -> int:
    """``ab_measure`` on the package under ``parent`` (a ``git archive`` of
    another commit) and on this checkout's, in the order parent, change,
    change, parent, each in its own process on the same card."""
    code = ("import runpy, sys; sys.path.insert(0, {root!r}); "
            "runpy.run_path({file!r}, run_name='chip_smoke_ab')['ab_measure']({greedy})")
    for root in (os.path.abspath(parent), ROOT, ROOT, os.path.abspath(parent)):
        subprocess.run([sys.executable, "-c", code.format(root=root, file=os.path.abspath(__file__),
                                                          greedy=greedy)], check=True)
    return 0


# ------------------------------------------------------------------ training
#
# The train slice on the card (``tailored_avsr_tpu_torch/train``): the
# flagship at full width with its training settings, bf16 autocast over f32
# master weights; then the checks below. Each train step must launch none
# of the forward-only kernels (the kernel routes test ``not self.training``);
# the eval step, the JAX package's ``deterministic=True``, must launch K1 or
# K2 and K3.

TRAIN_MICRO_STEPS = 32  # accum_grad 16: two optimizer updates
# f32 loss and gradient norm on the card against the CPU, train mode with
# every rate at 0, TF32 off: both sum in f32 in other orders, and CUDA's
# ctc_loss and cuDNN's convolution backward add in a run-dependent order
# (atomics). Relative.
CARD_VS_CPU_RTOL = 1e-4
# Resume: micro-steps 17-32 forward with the same weights and seeds in both
# runs (bit-equal forwards expected); the eval loss after update 2 moves by
# the nondeterministic order of update 2's gradient sums. Relative.
RESUME_RTOL = 1e-4
CANARY_CER = 20.0  # the CPU canary's threshold (tests/test_torch_port_train.py)
CANARY_STEPS = 400
_CANARY_WORDS = ("ABA", "CAD", "BIG", "DIG", "FACE", "HID")
_CANARY_HZ = {c: 220.0 * 2.0 ** (k / 4.0) for k, c in enumerate(" ABCDEFGHIJ")}


def _flagship_train_cfg(**encoder):
    """The flagship (``_tpu.yaml``: 12 blocks, 256-d, 6 decoder layers) with
    its training settings, K1-K3 enabled for the eval step."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(FLAGSHIP)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True, **encoder)
    return cfg


def _zero_rates(cfg) -> None:
    """Every dropout, drop and SpecAug rate of ``cfg`` at 0."""
    zero = {"dropout_rate": 0.0, "positional_dropout_rate": 0.0}
    cfg.specaug = None
    cfg.encoder_conf = dict(cfg.encoder_conf, attention_dropout_rate=0.0, stochastic_depth_rate=0.0,
                            acoustic_branch_drop_rate=0.0, **zero)
    cfg.decoder_conf = dict(cfg.decoder_conf, self_attention_dropout_rate=0.0,
                            src_attention_dropout_rate=0.0, **zero)
    cfg.acoustic_embed_conf = dict(cfg.acoustic_embed_conf, **zero)
    cfg.visual_embed_conf = dict(cfg.visual_embed_conf, **zero)
    cfg.audiovisual_fusion_conf = dict(cfg.audiovisual_fusion_conf, dropout_rate=0.0,
                                       acoustic_branch_drop_rate=0.0)
    cfg.ctc_conf = dict(cfg.ctc_conf, dropout_rate=0.0)


def _train_batch(seed: int, batch: int, seconds: float, vocab: int, chars: tuple, device) -> tuple:
    """A training batch as the port's loader hands it over: seeded int16
    audio at 16 kHz and uint8 88x88 crops at 25 fps, dequantised (audio /
    32768, video (x / 250 - 0.421) / 0.165, -1 past each length), lengths
    from 85 % to 100 % of the buffer, and ``chars`` = (lo, hi) characters
    of seeded text (ids 3 .. vocab-2: no blank, unk or sos/eos), -1 padded."""
    rs = np.random.RandomState(seed)
    samples, frames = int(seconds * 16000), int(seconds * 25)
    frac = rs.uniform(0.85, 1.0, batch)
    frac[0] = 1.0
    frame_lens = np.ceil(frac * frames).astype(np.int64)
    audio = torch.from_numpy(np.clip(rs.randn(batch, samples) * 3000, -32768, 32767).astype(np.int16))
    video = torch.from_numpy(rs.randint(0, 256, (batch, frames, 88, 88)).astype(np.uint8))
    text_lens = rs.randint(chars[0], chars[1] + 1, batch)
    text = np.full((batch, int(text_lens.max())), -1, np.int64)
    for i, n in enumerate(text_lens):
        text[i, :n] = rs.randint(3, vocab - 1, n)
    audio_lens = torch.from_numpy(frame_lens * 640)
    video_lens = torch.from_numpy(frame_lens)
    audio, video = audio.to(device).float() / 32768.0, (video.to(device).float() / 250.0 - 0.421) / 0.165
    audio = torch.where(torch.arange(samples, device=device)[None] < audio_lens.to(device)[:, None], audio, -1.0)
    vmask = torch.arange(frames, device=device)[None] < video_lens.to(device)[:, None]
    video = torch.where(vmask[..., None, None], video, -1.0)
    return (audio, audio_lens.to(device), video, video_lens.to(device),
            torch.from_numpy(text).to(device), torch.from_numpy(text_lens).to(device))


def _train_state(cfg, device, seed: int = 0):
    """(state, token list): the model built on the CPU from ``seed``, moved
    to ``device`` in f32 (the master weights), with the config's optimizer."""
    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.train.loop import create_train_state
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    tokens = load_token_list(cfg.token_list)
    model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(seed), device=device,
                        dtype=torch.float32)
    opt, _ = set_optimizer(cfg.training_settings, int(cfg.encoder_conf.get("output_size", 256)), 1,
                           model.named_parameters())
    return create_train_state(model, opt, seed=seed), tokens


def _finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _train_micro_steps(state, step, batches, first: int, last: int, timed: list = None,
                       profile: dict = None) -> list:
    """Micro-steps ``first`` .. ``last`` (1-based) over ``batches`` in turn;
    returns their losses. Each step ends in a host read of its loss. With
    ``profile``, the step ``profile["step"]`` runs under ``torch.profiler``
    and its device busy time, idle share and largest kernels land there."""
    losses = []
    accum = state.optimizer.accum_grad
    for i in range(first, last + 1):
        prof = None
        if profile is not None and i == profile["step"]:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats = step(state, batches[(i - 1) % len(batches)])
        loss = float(stats["loss"])
        wall = (time.perf_counter() - t0) * 1e3
        if timed is not None:
            timed.append(wall)
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
            profile.update(_device_breakdown(prof, wall))
        if not np.isfinite(loss) or not all(np.isfinite(float(v)) for v in stats.values()):
            raise AssertionError(f"micro-step {i}: stats not finite: {stats}")
        if state.optimizer.acc is not None and i % accum == accum - 1 and not _finite(state.optimizer.acc):
            raise AssertionError(f"micro-step {i}: accumulated gradients are not finite")
        losses.append(loss)
    return losses


# kernel-name patterns of the train step's device work, first match wins
# (cuDNN's BatchNorm kernels are named cudnn::bn_*: BatchNorm comes first)
_TRAIN_KERNEL_KINDS = (
    ("ctc_loss", ("ctc",)),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet", "matmul")),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("max-pool", ("max_pool", "pool")),
    ("copies and casts", ("copy", "memcpy", "memset", "cast")),
)


def _device_breakdown(prof, wall_ms: float) -> dict:
    """Device busy ms of a profiled step (the sum of its device events; one
    stream), its idle share of the step's wall time, and busy ms by kind of
    kernel (``_TRAIN_KERNEL_KINDS``, the rest elementwise and reductions)."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    kinds = {}
    for e in events:
        name = e.key.lower()
        kind = next((k for k, pats in _TRAIN_KERNEL_KINDS if any(p in name for p in pats)),
                    "elementwise and reductions")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}


def _set_kernels(model, on: bool) -> None:
    """Flash attention (K1/K2) and the fused cgMLP gate (K3) on or off in
    every layer (the eager path when off)."""
    from tailored_avsr_tpu_torch.tasks.common import set_kernels

    set_kernels(model, on)


def _valid_ids(out) -> list:
    ids, lens = out["ctc_argmax"].cpu(), out["ctc_argmax_lens"].cpu()
    return [ids[i, :n].tolist() for i, n in enumerate(lens.tolist())]


def flagship_train_phase(device, smi: str) -> dict:
    """The full-width train step: 4 x 20 s utterances, 32 micro-steps
    (accum_grad 16: two updates) in bf16 autocast over f32 master weights,
    no kernel launched; then the resume check and the eval step with the
    kernels (f32, greedy ids equal to the eager eval's). Returns the launch
    counts and the numbers printed."""
    from tailored_avsr_tpu_torch.train.checkpoint import load_train_state, save_train_state
    from tailored_avsr_tpu_torch.train.loop import make_eval_step, make_train_step

    cfg = _flagship_train_cfg()
    ts = cfg.training_settings
    state, tokens = _train_state(cfg, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"train path: flagship (12 blocks, 256-d, 6 decoder layers, {n_params / 1e6:.1f}M parameters), "
          f"batch {ts['batch_size']} x {ts['nframes'] // 25} s, Adam + Noam (warmup {ts['warmup_steps']}, "
          f"factor {ts['noam_factor']}), accum_grad {ts['accum_grad']}, bf16 autocast over f32 master weights, "
          f"seeded weights and data")
    seconds = ts["nframes"] / 25
    # 12.5-15 characters a second: 250-300 at 20 s, CTC-feasible at T = 500
    chars = (int(12.5 * seconds), int(15 * seconds))
    batches = [_train_batch(10 + k, ts["batch_size"], seconds, len(tokens), chars, device) for k in range(4)]
    step = make_train_step(torch.bfloat16)
    params0 = [p.detach().clone() for p in state.model.parameters()]
    stats0 = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
    with tempfile.TemporaryDirectory() as tmp:
        resume_path = os.path.join(tmp, "train_state.pt")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        walls = []
        accum = state.optimizer.accum_grad
        losses = _train_micro_steps(state, step, batches, 1, accum, walls)
        save_train_state(state, 1, resume_path)  # after update 1
        losses += _train_micro_steps(state, step, batches, accum + 1, TRAIN_MICRO_STEPS, walls)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        if any(launches.values()):
            raise AssertionError(f"a train step launched a forward-only kernel: {launches}")
        if state.optimizer.count != TRAIN_MICRO_STEPS // accum:
            raise AssertionError(f"{state.optimizer.count} optimizer updates, expected {TRAIN_MICRO_STEPS // accum}")
        params = list(state.model.parameters())
        moved = sum(not torch.equal(a, b) for a, b in zip(params, params0))
        stats = {k: v for k, v in state.model.state_dict().items() if "running" in k}
        bn_moved = sum(not torch.equal(stats[k], stats0[k]) for k in stats0)
        if not _finite(params) or not _finite(state.optimizer.mu) or not _finite(state.optimizer.nu):
            raise AssertionError("parameters or Adam moments are not finite after the updates")
        if moved < len(params) * 0.95 or bn_moved != len(stats0):
            raise AssertionError(f"{moved}/{len(params)} parameters and {bn_moved}/{len(stats0)} BatchNorm "
                                 "statistics moved")
        warm = walls[2:]
        speech = float(batches[0][1].sum() + batches[1][1].sum() + batches[2][1].sum() + batches[3][1].sum()) / 4
        speech /= 16000
        med = float(np.median(warm))
        out = {"micro_step_ms_median": med, "micro_step_ms_min": float(min(warm)),
               "micro_step_ms_max": float(max(warm)), "micro_step_ms_p10": float(np.percentile(warm, 10)),
               "micro_step_ms_p90": float(np.percentile(warm, 90)), "warm_steps": len(warm),
               "speech_s_per_wall_s": speech / (med / 1e3), "peak_bytes": int(peak),
               "first_loss": losses[0], "last_loss": losses[-1], "card": smi}
        print(f"  {TRAIN_MICRO_STEPS} micro-steps: losses {losses[0]:.2f} -> {losses[-1]:.2f}, finite; "
              f"launches over the train steps {launches} (all 0); {moved}/{len(params)} parameters and "
              f"{bn_moved}/{len(stats0)} BatchNorm statistics moved")
        print(f"  warm micro-step wall ms over {len(warm)} steps: median {med:.1f}, p10 {out['micro_step_ms_p10']:.1f}, "
              f"p90 {out['micro_step_ms_p90']:.1f}, min {out['micro_step_ms_min']:.1f}, max {out['micro_step_ms_max']:.1f} "
              f"(each {accum}-th step adds the optimizer update); {out['speech_s_per_wall_s']:.1f} s of speech trained "
              f"per wall second; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; card {smi}")

        # resume: a fresh state from the file written after update 1 runs update 2
        fresh, _ = _train_state(cfg, device, seed=1)
        fresh, epoch = load_train_state(fresh, resume_path)
        loaded_step = fresh.step
        profile = {"step": accum + 3}  # a warm micro-step that does not update
        resumed = _train_micro_steps(fresh, step, batches, accum + 1, TRAIN_MICRO_STEPS, profile=profile)
    profile.pop("step")
    print(f"  profiled micro-step (torch.profiler): device busy {profile['device_busy_ms']:.1f} ms of "
          f"{profile['profiled_wall_ms']:.1f} ms wall (idle share {profile['idle_share']:.3f}); device ms by kind: "
          + ", ".join(f"{k} {v:.1f}" for k, v in profile["device_ms_by_kind"].items()))
    out["profile"] = profile
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[accum:]))
    eval_step = make_eval_step()
    e_live = float(eval_step(state, batches[0])["loss"])
    e_res = float(eval_step(fresh, batches[0])["loss"])
    d_eval = abs(e_res - e_live) / abs(e_live)
    print(f"  resume after update 1 (epoch {epoch}, step {loaded_step}): micro-steps {accum + 1}-{TRAIN_MICRO_STEPS} losses "
          f"max rel diff {d_loss:.3e}, eval loss after update 2 {e_res:.6f} vs {e_live:.6f} (rel {d_eval:.3e}); "
          f"tol {RESUME_RTOL:g} relative")
    if d_loss > RESUME_RTOL or d_eval > RESUME_RTOL:
        raise AssertionError("the resumed run disagrees with the uninterrupted one")
    del fresh

    # eval on the trained weights: the kernels, then the eager path (f32)
    _reset_counts()
    got = eval_step(state, batches[0])
    eval_launches = _counts()
    if not (eval_launches["K1"] + eval_launches["K2"] > 0 and eval_launches["K3"] > 0):
        raise AssertionError(f"the eval step did not launch K1/K2 and K3: {eval_launches}")
    _set_kernels(state.model, False)
    before = _counts()
    want = eval_step(state, batches[0])
    if _counts() != before:
        raise AssertionError("the eager eval step launched a kernel")
    _set_kernels(state.model, True)
    same = _valid_ids(got) == _valid_ids(want)
    d = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    print(f"  eval step (f32, T=500): launches {eval_launches}; greedy ids equal to the eager eval's: {same}; "
          f"loss {float(got['loss']):.6f} vs eager {float(want['loss']):.6f} (rel {d:.2e})")
    if not same:
        raise AssertionError("the eval step's greedy CTC ids differ from the eager eval's")
    out.update(train_launches=launches, eval_launches=eval_launches, resume_rel=max(d_loss, d_eval))
    return out


def card_vs_cpu_phase(device) -> None:
    """f32, full width cut to 2 encoder and 1 decoder layers, 2 x 2 s, train
    mode with every rate at 0, TF32 off: loss and gradient global norm on the
    card against the CPU on the same weights and inputs."""
    cfg = _flagship_train_cfg(num_blocks=2, acoustic_use_attn=[False, True], visual_use_attn=[True, True])
    cfg.decoder_conf = dict(cfg.decoder_conf, num_blocks=1)
    _zero_rates(cfg)
    results = {}
    for dev in (torch.device("cpu"), device):
        state, tokens = _train_state(cfg, dev)
        model = state.model.train()
        batch = _train_batch(20, 2, 2.0, len(tokens), (20, 30), dev)
        loss, _ = model(*batch)
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
        results[dev.type] = (float(loss.detach()), float(norm))
    (l_cpu, n_cpu), (l_gpu, n_gpu) = results["cpu"], results["cuda"]
    dl, dn = abs(l_gpu - l_cpu) / abs(l_cpu), abs(n_gpu - n_cpu) / abs(n_cpu)
    print(f"  f32 card vs CPU (2 encoder + 1 decoder layers, 256-d, 2 x 2 s, rates 0, TF32 off): loss "
          f"{l_gpu:.6f} vs {l_cpu:.6f} (rel {dl:.2e}), gradient norm {n_gpu:.6f} vs {n_cpu:.6f} (rel {dn:.2e}); "
          f"tol {CARD_VS_CPU_RTOL:g} relative")
    if dl > CARD_VS_CPU_RTOL or dn > CARD_VS_CPU_RTOL:
        raise AssertionError("f32 training on the card disagrees with the CPU")


def _canary_cfg():
    """``__graft_entry__._flagship_cfg(tiny=True)``'s shapes (64-d, 2 blocks,
    2 decoder layers), no SpecAug, constant learning rate."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/AVSR/tailored_transformer+ctc_spanish.yaml"))
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.encoder_conf = dict(cfg.encoder_conf, output_size=64, linear_units=96, cgmlp_linear_units=96,
                            cgmlp_conv_kernel=7, num_blocks=2, acoustic_use_attn=[False, True],
                            visual_use_attn=[True, True])
    cfg.audiovisual_fusion_conf = dict(cfg.audiovisual_fusion_conf, output_size=64, hidden_units=96)
    cfg.decoder_conf = dict(cfg.decoder_conf, linear_units=96, num_blocks=2)
    cfg.specaug = None
    cfg.training_settings = {"optimizer": "adam", "scheduler": "constant", "learning_rate": 2e-3,
                             "grad_clip": 5.0, "accum_grad": 1}
    return cfg


def _canary_batch(tokens, device) -> tuple:
    """4 utterances whose audio spells the transcript (one tone a character,
    as ``tests/synthetic.py``), random lip crops, seeded."""
    rs = np.random.RandomState(0)
    index = {t: i for i, t in enumerate(tokens)}
    audios, videos, texts = [], [], []
    for _ in range(4):
        frames = 12 + rs.randint(-3, 4)
        text = " ".join(rs.choice(_CANARY_WORDS, size=rs.randint(1, 3)))
        bounds = np.linspace(0, frames * 640, len(text) + 1).astype(int)
        wave = np.zeros(frames * 640)
        for c, lo, hi in zip(text, bounds[:-1], bounds[1:]):
            wave[lo:hi] = np.sin(2 * np.pi * _CANARY_HZ[c] * np.arange(lo, hi) / 16000)
        audios.append(0.3 * wave + 0.01 * rs.randn(frames * 640))
        videos.append((rs.rand(frames, 88, 88) * 250 / 250 - 0.421) / 0.165)
        texts.append([index["<space>" if c == " " else c] for c in text])
    pad = lambda xs, v: np.stack([np.concatenate([x, np.full((max(map(len, xs)) - len(x),) + np.shape(x)[1:], v)])  # noqa: E731
                                  for x in xs])
    t = lambda x, dt: torch.from_numpy(np.asarray(x, dt)).to(device)  # noqa: E731
    return (t(pad(audios, -1.0), np.float32), t([len(a) for a in audios], np.int64),
            t(pad(videos, -1.0), np.float32), t([len(v) for v in videos], np.int64),
            t(pad(texts, -1), np.int64), t([len(x) for x in texts], np.int64))


def learning_canary(device, steps: int = CANARY_STEPS) -> dict:
    """The tiny model memorises 4 tone-spelled utterances on the card: greedy
    CTC CER below the CPU canary's threshold, checked every 25 steps."""
    from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse
    from tailored_avsr_tpu_torch.evaluation.wer import cer_from_ids
    from tailored_avsr_tpu_torch.train.loop import make_eval_step, make_train_step

    cfg = _canary_cfg()
    state, tokens = _train_state(cfg, device)
    batch = _canary_batch(tokens, device)
    step, eval_step = make_train_step(), make_eval_step()
    refs = [t[:n].tolist() for t, n in zip(batch[4].cpu(), batch[5].cpu())]
    t0 = time.perf_counter()
    first = best = None
    for i in range(1, steps + 1):
        _, stats = step(state, batch)
        first = float(stats["loss"]) if first is None else first
        if i % 25 == 0:
            out = eval_step(state, batch)
            hyps = ctc_greedy_collapse(out["ctc_argmax"].cpu().numpy(), out["ctc_argmax_lens"].cpu().numpy())
            cer = cer_from_ids(refs, hyps)
            best = cer if best is None else min(best, cer)
            if best < CANARY_CER:
                break
    last = float(stats["loss"])
    wall = time.perf_counter() - t0
    print(f"  learning canary (64-d tiny flagship, 4 tone-spelled utterances, Adam at constant lr "
          f"{cfg.training_settings['learning_rate']:g}): best greedy CER {best:.1f}% after {i} steps "
          f"(threshold {CANARY_CER:g}%), loss {first:.2f} -> {last:.2f}, {wall:.1f} s")
    if best >= CANARY_CER:
        raise AssertionError(f"the canary did not learn: best CER {best}%")
    return {"steps": i, "best_cer": best, "first_loss": first, "last_loss": last}


# ---------------------------------------------------------------- the Branchformer family
# The paper's own models at full width (12 blocks, 256-d, 6 decoder layers),
# seeded weights, use_flash and use_fused_csgu on as in the flagship phase:
# the audio-only ASR and video-only VSR Branchformers (learned_ave merges:
# the branch scores) and the conventional AVSR encoder (two Branchformer
# stacks). Each path's launch counts are set to 0 before it and read after.

ASR_CONFIG = os.path.join(ROOT, "configs/ASR/branchformer_transformer+ctc_spanish.yaml")
VSR_CONFIG = os.path.join(ROOT, "configs/VSR/conv3dresnet18_branchformer_transformer+ctc_spanish.yaml")
CONVENTIONAL_CONFIG = os.path.join(ROOT, "configs/AVSR/conventional_transformer+ctc_spanish.yaml")
# f32 through the kernels against the eager path on the same engine: greedy
# ids identical, CTC log-probs as the flagship's gate, every layer's learned
# branch weights (softmaxes of pooled f32 logits: the kernels move them by
# f32 rounding, ~1e-6)
FAMILY_LOGP_ATOL = 1e-3
FAMILY_WEIGHT_ATOL = 1e-4


def _family_engine(path: str, device, dtype: str, lm: bool = False, **inference_conf):
    """A Branchformer-family serving engine from the repo's config, seeded
    weights, the encoder kernels on; with ``lm`` the 16-layer LM too."""
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(path)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.dtype = dtype
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True)
    cfg.inference_conf = dict(cfg.inference_conf, **inference_conf)
    lm_cfg = None
    if lm:
        lm_cfg = load_config(LM_CONFIG)
        lm_cfg.token_list = os.path.join(ROOT, lm_cfg.token_list)
    return Speech2Text(cfg, lm_config=lm_cfg, rng_seed=0, device=device)


def _speech_request(seed: int, batch: int, seconds: int, kind: str) -> dict:
    """A single-stream request as a client sends it: int16 audio at 16 kHz
    (``asr``) or uint8 88x88 lip crops at 25 fps (``vsr``), lengths between
    60 % and 100 % of the buffer."""
    rs = np.random.RandomState(seed)
    frac = rs.uniform(0.6, 1.0, batch)
    frac[0] = 1.0
    if kind == "asr":
        samples = seconds * 16000
        return {"speech": np.clip(rs.randn(batch, samples) * 3000, -32768, 32767).astype(np.int16),
                "speech_lengths": (frac * samples).astype(np.int32)}
    frames = seconds * 25
    return {"speech": rs.randint(0, 256, (batch, frames, 88, 88)).astype(np.uint8),
            "speech_lengths": np.ceil(frac * frames).astype(np.int32)}


def _flat_weights(branch_weights) -> dict:
    """``[(layer, aux)]`` (aux per modality for the conventional encoder) ->
    {"layer l [modality] weight_*": (B,) tensor}."""
    flat = {}
    for layer, aux in branch_weights:
        for key, value in aux.items():
            for sub, w in (value.items() if isinstance(value, dict) else [("", value)]):
                flat[f"layer {layer} {key} {sub}".strip()] = w
    return flat


def _family_outputs(engine, batch: dict):
    """(greedy ids, CTC log-probs, encoder lengths, flat branch weights) of
    one request; the encoder output must be a finite (B, T, d_model)."""
    with torch.inference_mode():
        enc, lens, aux = engine.model.encode(*engine.inputs(batch))
        logp = engine.model.ctc.log_softmax(enc)
        ids = engine.model.ctc.argmax(enc)
    want = (_utterances(batch), engine.model.ctc.ctc_lo.in_features)
    if (enc.shape[0], enc.shape[2]) != want or not bool(torch.isfinite(logp).all()):
        raise AssertionError(f"encoder output {tuple(enc.shape)} is not a finite (B, T, D) with (B, D) {want}")
    return ids, logp, lens, _flat_weights(aux.get("branch_weights", []))


def _family_serve(engine, name: str, batch: dict, expect: dict) -> list:
    """One ``Speech2Text.greedy`` call whose launches must be ``expect``
    (``_exact_call``)."""
    hyps = _exact_call(name, lambda: engine.greedy(batch), expect)
    if len(hyps) != _utterances(batch):
        raise AssertionError(f"{name}: {len(hyps)} transcripts for {_utterances(batch)} utterances")
    return hyps


def _family_gate(engine, name: str, batch: dict, expect: dict, weights: bool = True) -> None:
    """An f32 engine's request through the kernels (launches ``expect``), then
    on the eager path (kernels off, no launch) on the same weights: greedy
    ids identical, CTC log-probs within FAMILY_LOGP_ATOL, every learned
    branch weight within FAMILY_WEIGHT_ATOL (an encoder with ``weights``
    must return some)."""
    _family_serve(engine, f"f32 {name}", batch, expect)
    ids_k, logp_k, lens_k, w_k = _family_outputs(engine, batch)
    _set_kernels(engine.model, False)
    try:
        _family_serve(engine, f"f32 eager {name}", batch, dict.fromkeys(expect, 0))
        ids_e, logp_e, lens_e, w_e = _family_outputs(engine, batch)
    finally:
        _set_kernels(engine.model, True)
    valid = torch.arange(ids_k.shape[1], device=ids_k.device)[None] < lens_k[:, None]
    same = bool(torch.equal(lens_k, lens_e)) and bool((ids_k == ids_e)[valid].all())
    dlogp = float((logp_k - logp_e).abs()[valid].max())
    dw = max((float((w_k[k].float() - w_e[k].float()).abs().max()) for k in w_e), default=0.0)
    print(f"  f32 {name}: greedy ids identical to the eager path: {same}; max |CTC log-prob diff| {dlogp:.3e} "
          f"(tol {FAMILY_LOGP_ATOL:g}); {len(w_e)} learned branch weights, max |diff| {dw:.3e} "
          f"(tol {FAMILY_WEIGHT_ATOL:g})")
    if not same or dlogp > FAMILY_LOGP_ATOL or set(w_k) != set(w_e) or bool(w_e) != weights \
            or dw > FAMILY_WEIGHT_ATOL:
        raise AssertionError(f"f32 {name}: the kernel path disagrees with the eager path")


def _path_counts(what: str, required: tuple) -> dict:
    """The counts of a path (set to 0 before it); each ``required`` kernel
    must have launched."""
    counts = _counts()
    print(f"  launches over the {what} path: {counts}")
    if min(counts[k] for k in required) <= 0:
        raise AssertionError(f"a kernel of the {what} path never launched: {counts}")
    return counts


def asr_phase(device) -> dict:
    """ASR greedy at (a) 32 x 4 s (T = 99: K2, K3) and (b) 24 x 20 s (T = 499:
    K1, K3), 12 launches of each a call; the f32 gate at both; bf16 walls and
    a profiled call; then the ASR beam + LM at (a), f32 through K4 held to
    the plain group attend, one bf16 call timed."""
    out = {}
    req_a, req_b = _speech_request(1, 32, 4, "asr"), _speech_request(2, 24, 20, "asr")
    expect_a, expect_b = {"K1": 0, "K2": 12, "K3": 12}, {"K1": 12, "K2": 0, "K3": 12}
    # the beam phase's settings (beam 10, ctc 0.1, lm 0.4); the config's
    # beam_size 30 is not what the flagship's beam phase serves
    bf16 = _family_engine(ASR_CONFIG, device, "bfloat16", lm=True, beam_size=10)
    f32 = _family_engine(ASR_CONFIG, device, "float32", lm=True, beam_size=10, nbest=2)
    print("ASR path: Branchformer (12 blocks, 256-d, learned_ave), log-mel + conv2d, seeded weights, int16 audio")
    _reset_counts()
    hyp_a = _family_serve(bf16, "bf16 ASR request (a) 32 x 4 s, T=99 (first call)", req_a, expect_a)
    hyp_b = _family_serve(bf16, "bf16 ASR request (b) 24 x 20 s, T=499 (first call)", req_b, expect_b)
    print(f"  sample transcripts: (a) {hyp_a[0][:40]!r}  (b) {hyp_b[0][:40]!r}")
    _family_gate(f32, "ASR request (a)", req_a, expect_a)
    _family_gate(f32, "ASR request (b)", req_b, expect_b)
    out["greedy_a"] = greedy_profile(bf16, req_a, "bf16 ASR request (a) 32 x 4 s")
    out["greedy_b"] = greedy_profile(bf16, req_b, "bf16 ASR request (b) 24 x 20 s")
    out["greedy_launches"] = _path_counts("ASR greedy", ("K1", "K2", "K3"))

    print("ASR beam path: + 16-layer 512-d LM, beam 10, ctc 0.1, lm 0.4, request (a)")
    _reset_counts()
    _nbest(bf16, "bf16 ASR beam (first call)", req_a)
    hyp_bf16 = _nbest(bf16, "bf16 ASR beam", req_a)
    hyp_f32 = _nbest(f32, "f32 ASR beam", req_a)
    before = _counts()["K4"]
    f32.fused_group_attend = False  # the plain group attend on the card
    hyp_plain = _nbest(f32, "f32 ASR beam, plain group attend", req_a)
    f32.fused_group_attend = None
    if _counts()["K4"] != before:
        raise AssertionError("fused_group_attend: false launched the group-attend kernel")
    _held_against_plain(hyp_f32, hyp_plain, "K4")
    print(f"  sample 1-best: bf16 {hyp_bf16[0][0][0][:40]!r}  f32 {hyp_f32[0][0][0][:40]!r}")
    out["beam_launches"] = _path_counts("ASR beam", ("K2", "K3", "K4", "K5"))
    return out


def vsr_phase(device) -> dict:
    """VSR greedy at (a): 32 x 100 uint8 lip frames (T = 100: K2, K3, 12 a
    call), the f32 gate, bf16 walls and a profiled call."""
    req = _speech_request(1, 32, 4, "vsr")
    expect = {"K1": 0, "K2": 12, "K3": 12}
    bf16 = _family_engine(VSR_CONFIG, device, "bfloat16")
    f32 = _family_engine(VSR_CONFIG, device, "float32")
    print("VSR path: Conv3D + ResNet-18, Branchformer (12 blocks, 256-d, learned_ave), seeded weights, uint8 video")
    _reset_counts()
    hyp = _family_serve(bf16, "bf16 VSR request (a) 32 x 100 frames, T=100 (first call)", req, expect)
    print(f"  sample transcript: {hyp[0][:40]!r}")
    _family_gate(f32, "VSR request (a)", req, expect)
    out = {"greedy_a": greedy_profile(bf16, req, "bf16 VSR request (a) 32 x 100 frames")}
    out["greedy_launches"] = _path_counts("VSR greedy", ("K2", "K3"))
    return out


def conventional_phase(device) -> dict:
    """Conventional AVSR greedy at (a) (two 12-layer Branchformer stacks:
    K2 24 and K3 24 a call), the f32 gate, bf16 walls and a profiled call."""
    req = _request(1, 32, 4)
    expect = {"K1": 0, "K2": 24, "K3": 24}
    bf16 = _family_engine(CONVENTIONAL_CONFIG, device, "bfloat16")
    f32 = _family_engine(CONVENTIONAL_CONFIG, device, "float32")
    print("conventional AVSR path: two Branchformer stacks (12 blocks each, 256-d, learned_ave), adaptive fusion")
    _reset_counts()
    hyp = _family_serve(bf16, "bf16 conventional request (a) 32 x 4 s, T=100 (first call)", req, expect)
    print(f"  sample transcript: {hyp[0][:40]!r}")
    _family_gate(f32, "conventional request (a)", req, expect)
    out = {"greedy_a": greedy_profile(bf16, req, "bf16 conventional request (a) 32 x 4 s")}
    out["greedy_launches"] = _path_counts("conventional greedy", ("K2", "K3"))
    return out


def _asr_train_batch(seed: int, batch: int, seconds: float, vocab: int, chars: tuple, device) -> tuple:
    """An ASR training batch as the port's loader hands it over: seeded int16
    audio / 32768, -1 past each length (85-100 % of the buffer), ``chars``
    characters of seeded text, -1 padded."""
    rs = np.random.RandomState(seed)
    samples = int(seconds * 16000)
    frac = rs.uniform(0.85, 1.0, batch)
    frac[0] = 1.0
    lens = torch.from_numpy((frac * samples).astype(np.int64) // 640 * 640).to(device)
    audio = torch.from_numpy(np.clip(rs.randn(batch, samples) * 3000, -32768, 32767).astype(np.int16))
    audio = audio.to(device).float() / 32768.0
    audio = torch.where(torch.arange(samples, device=device)[None] < lens[:, None], audio, -1.0)
    text_lens = rs.randint(chars[0], chars[1] + 1, batch)
    text = np.full((batch, int(text_lens.max())), -1, np.int64)
    for i, n in enumerate(text_lens):
        text[i, :n] = rs.randint(3, vocab - 1, n)
    return audio, lens, torch.from_numpy(text).to(device), torch.from_numpy(text_lens).to(device)


def asr_train_phase(device) -> dict:
    """ASR training micro-steps at the config's settings (4 x 20 s, Adam +
    Noam, accum_grad 16: one update) in bf16 autocast over f32 master
    weights: no kernel launched, losses and gradients finite, every
    parameter moved by the update."""
    return family_train_phase("ASR", ASR_CONFIG, device, seed=30)


def family_train_phase(name: str, path: str, device, seed: int) -> dict:
    """``accum_grad`` training micro-steps (one update) of the config at
    ``path`` at its settings (batch x 20 s, 250-300 characters an
    utterance, Adam + Noam) in bf16 autocast over f32 master weights: no
    kernel launched, losses and gradients finite, every parameter moved by
    the update; the median warm micro-step, speech trained per wall second
    and ``torch.cuda.max_memory_allocated``."""
    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(path)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True)
    ts = cfg.training_settings
    tokens = load_token_list(cfg.token_list)
    model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(0), device=device, dtype=torch.float32)
    opt, _ = set_optimizer(ts, int(cfg.encoder_conf["output_size"]), 1, model.named_parameters())
    state = create_train_state(model, opt)
    micro_steps = state.optimizer.accum_grad
    seconds = ts["nframes"] / 25
    chars = (int(12.5 * seconds), int(15 * seconds))  # 250-300: CTC-feasible at T = 499
    make_batch = _train_batch if cfg.task == "avsr" else _asr_train_batch
    batches = [make_batch(seed + k, ts["batch_size"], seconds, len(tokens), chars, device) for k in range(4)]
    params0 = [p.detach().clone() for p in model.parameters()]
    print(f"{name} train path: {sum(p.numel() for p in params0) / 1e6:.1f}M parameters, batch {ts['batch_size']} x "
          f"{seconds:g} s, Adam + Noam, accum_grad {ts['accum_grad']}, bf16 autocast over f32 master weights")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    walls = []
    losses = _train_micro_steps(state, make_train_step(torch.bfloat16), batches, 1, micro_steps, walls)
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"a {name} train step launched a forward-only kernel: {launches}")
    names = [n for n, _ in model.named_parameters()]
    still = [n for n, p, p0 in zip(names, model.parameters(), params0) if torch.equal(p, p0)]
    if state.optimizer.count != 1 or still or not _finite(model.parameters()):
        raise AssertionError(f"{state.optimizer.count} updates; parameters not moved: {still[:8]}")
    warm = walls[2:]
    med = float(np.median(warm))
    speech = float(sum(b[1].sum() for b in batches)) / len(batches) / 16000
    out = {"micro_step_ms_median": med, "micro_step_ms_p10": float(np.percentile(warm, 10)),
           "micro_step_ms_p90": float(np.percentile(warm, 90)), "speech_s_per_wall_s": speech / (med / 1e3),
           "peak_bytes": int(torch.cuda.max_memory_allocated()), "first_loss": losses[0], "last_loss": losses[-1],
           "launches": launches}
    print(f"  {micro_steps} micro-steps: losses {losses[0]:.2f} -> {losses[-1]:.2f}, finite; launches "
          f"{launches} (all 0); all {len(names)} parameters moved by the update; warm micro-step wall ms median "
          f"{med:.1f} (p10 {out['micro_step_ms_p10']:.1f}, p90 {out['micro_step_ms_p90']:.1f}); "
          f"{out['speech_s_per_wall_s']:.1f} s of speech trained per wall second; max_memory_allocated "
          f"{out['peak_bytes'] / 2**30:.2f} GiB")
    return out


def branchformer_phase(device) -> dict:
    """The family's paths in turn, the engines freed between them; returns
    each path's numbers and launch counts."""
    out = {}
    for name, phase in (("asr", asr_phase), ("vsr", vsr_phase), ("conventional", conventional_phase),
                        ("asr_train", asr_train_phase)):
        t0 = time.perf_counter()
        out[name] = phase(device)
        torch.cuda.empty_cache()
        print(f"  ({name} phase: {time.perf_counter() - t0:.1f} s)")
    return out


# ---------------------------------------------------------------- Mask-CTC and the transducer
# The repo's last two model configs at full width, seeded weights, the
# encoder kernels on: Mask-CTC on the tailored AVSR encoder (K2 19, K3 5 a
# call at request (a)) and the RNN-T transducer on the ASR Branchformer
# (K2 or K1 12, K3 12 a call). Their searches (the MLM rounds, the greedy
# transducer decode, the ALSD beam) and their train steps launch no kernel:
# every call's launches are asserted exactly.

MASKCTC_CONFIG = os.path.join(ROOT, "configs/AVSR/tailored_maskctc_spanish.yaml")
TRANSDUCER_CONFIG = os.path.join(ROOT, "configs/ASR/branchformer_transducer_spanish.yaml")
# f32 through the kernels against the eager path of the same engine: ids
# identical, CTC log-probs within this; the transducer beam's 1-best held by
# ``envelope_gate`` to the eager run (its 1-best at its score within this,
# or a near-tied swap of the top two, whose margin is printed)
MT_ATOL = 1e-3


def _exact_call(name: str, call, expect: dict):
    """One serving call whose launches of every kernel must be ``expect``
    (0 for a kernel not named); prints its wall time."""
    return _exact_call_ms(name, call, expect)[0]


def _exact_call_ms(name: str, call, expect: dict) -> tuple:
    """``_exact_call`` -> (its result, its wall ms)."""
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    wall = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in _counts().items()}
    want = {k: expect.get(k, 0) for k in launched}
    print(f"  {name}: {wall:.1f} ms wall, launches {({k: v for k, v in launched.items() if v})}")
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, expected {want}")
    return out, wall


def _ids(hyps) -> list:
    return [h[0][2] for h in hyps]


def _kernel_vs_eager(engine, name: str, call, expect: dict):
    """``call`` of an f32 engine through the kernels (launches ``expect``),
    then on the eager path (kernels off, no launch); returns both results."""
    return _exact_call(f"f32 {name}", call, expect), _eager_call(engine, name, call)


def _eager_call(engine, name: str, call):
    """``call`` of an f32 engine on the eager path (kernels off, no launch)."""
    _set_kernels(engine.model, False)
    try:
        return _exact_call(f"f32 eager {name}", call, {})
    finally:
        _set_kernels(engine.model, True)


def _masked_tokens(engine, batch: dict) -> tuple:
    """(tokens masked before the MLM rounds, tokens, the largest CTC
    posterior on a valid frame) of one Mask-CTC request."""
    from tailored_avsr_tpu_torch.decode.maskctc import collapse_rows

    with torch.inference_mode():
        enc, lens, _ = engine.model.encode(*engine.inputs(batch))
        best, ids = engine.model.ctc.log_softmax(enc).max(dim=-1)
    _, probs, n = collapse_rows(best.exp(), ids, lens, 0, engine.model.mask_token)
    valid = torch.arange(probs.shape[1], device=probs.device)[None] < n[:, None]
    frames = torch.arange(best.shape[1], device=best.device)[None] < lens[:, None]
    masked = int(((probs < engine.maskctc_threshold) & valid).sum())
    return masked, int(n.sum()), float(best.exp()[frames].max())


def maskctc_phase(device) -> dict:
    """Mask-CTC nbest at request (a) 32 x 4 s (T = 100): K2 19, K3 5 a call
    and no kernel in the 10 MLM rounds, bf16 and f32; f32 ids identical to
    the eager path's, CTC log-probs within MT_ATOL; the tokens masked; bf16
    walls and a profiled call."""
    req = _request(1, 32, 4)
    expect = {"K2": 19, "K3": 5}
    bf16 = _family_engine(MASKCTC_CONFIG, device, "bfloat16")
    f32 = _family_engine(MASKCTC_CONFIG, device, "float32")
    rounds = [0]
    for engine in (bf16, f32):
        engine.model.decoder.register_forward_hook(lambda *_: rounds.__setitem__(0, rounds[0] + 1))
    n_iter = bf16.maskctc_n_iterations
    print(f"Mask-CTC path: tailored AVSR encoder (12 blocks, 256-d) + 6-layer MLM decoder over V + 1 tokens, "
          f"{n_iter} rounds, threshold {bf16.maskctc_threshold}, seeded weights, request (a) 32 x 4 s")
    _reset_counts()
    for dtype, engine in (("bf16", bf16), ("bf16", bf16), ("f32", f32)):
        rounds[0] = 0
        hyps = _exact_call(f"{dtype} Mask-CTC nbest (a)", lambda: engine.nbest(req), expect)
        if rounds[0] != n_iter or len(hyps) != 32 or any(len(h) != 1 or h[0][3] != 0.0 for h in hyps):
            raise AssertionError(f"{rounds[0]} MLM rounds, {len(hyps)} n-best lists: expected {n_iter}, 32 of one")
    print(f"  sample transcripts: bf16 {hyps[0][0][0][:40]!r}")
    launches = _path_counts("Mask-CTC", ("K2", "K3"))
    out = {"launches": launches}
    for dtype, engine in (("bf16", bf16), ("f32", f32)):
        masked, tokens, top = _masked_tokens(engine, req)
        print(f"  {dtype}: {masked} of {tokens} tokens masked before the MLM rounds (largest CTC posterior "
              f"{top:.4f} < {engine.maskctc_threshold}: every round runs)")
        out[f"masked_{dtype}"] = [masked, tokens]
    hyp_k, hyp_e = _kernel_vs_eager(f32, "Mask-CTC nbest (a)", lambda: f32.nbest(req), expect)
    ids_k, logp_k, lens_k = _ctc(f32, req)
    _set_kernels(f32.model, False)
    try:
        _, logp_e, lens_e = _ctc(f32, req)
    finally:
        _set_kernels(f32.model, True)
    valid = torch.arange(ids_k.shape[1], device=device)[None] < lens_k[:, None]
    same = _ids(hyp_k) == _ids(hyp_e) and bool(torch.equal(lens_k, lens_e))
    dlogp = float((logp_k - logp_e).abs()[valid].max())
    print(f"  f32 Mask-CTC (a): ids identical to the eager path: {same}; max |CTC log-prob diff| {dlogp:.3e} "
          f"(tol {MT_ATOL:g})")
    if not same or dlogp > MT_ATOL:
        raise AssertionError("f32 Mask-CTC through the kernels disagrees with the eager path")
    out["nbest_a"] = call_profile(lambda: bf16.nbest(req), "bf16 Mask-CTC nbest (a) 32 x 4 s", host_events=False)
    return out


def _set_beam(engine, beam: int) -> None:
    engine.beam_config = dataclasses.replace(engine.beam_config, beam_size=beam)


def _beam_margins(hyp, hyp_eager) -> None:
    """Print the 1-best / 2-best margin of each utterance whose 1-best
    differs between the two runs."""
    for u, (g, w) in enumerate(zip(hyp, hyp_eager)):
        if g[0][2] != w[0][2]:
            print(f"    utterance {u}: 1-best differs; margins kernel {g[0][3] - g[1][3]:.3e}, "
                  f"eager {w[0][3] - w[1][3]:.3e}")


def transducer_phase(device) -> dict:
    """The RNN-T transducer ASR: greedy (beam 1) at (a) 32 x 4 s (T = 99: K2
    12, K3 12 a call) and (b) 24 x 20 s (T = 499: K1 12, K3 12), f32 ids
    identical to the eager path's; the config's beam 30 at (a) (ALSD,
    T + max_symbols = 198 steps), f32 1-best held to the eager run by
    ``envelope_gate``; bf16 walls and a profiled call of each."""
    out = {}
    req_a, req_b = _speech_request(1, 32, 4, "asr"), _speech_request(2, 24, 20, "asr")
    expect_a, expect_b = {"K2": 12, "K3": 12}, {"K1": 12, "K3": 12}
    bf16 = _family_engine(TRANSDUCER_CONFIG, device, "bfloat16")
    f32 = _family_engine(TRANSDUCER_CONFIG, device, "float32")
    beam = bf16.beam_config.beam_size
    print(f"transducer path: Branchformer (12 blocks, 256-d) + 1-layer 256-d LSTM prediction network + "
          f"320-d joint, seeded weights, int16 audio; greedy (beam 1) and the config's beam {beam}")
    for engine in (bf16, f32):
        _set_beam(engine, 1)
    _reset_counts()
    hyp_a = _exact_call("bf16 transducer greedy (a) 32 x 4 s, T=99 (first call)", lambda: bf16.nbest(req_a),
                        expect_a)
    hyp_b = _exact_call("bf16 transducer greedy (b) 24 x 20 s, T=499 (first call)", lambda: bf16.nbest(req_b),
                        expect_b)
    print(f"  sample transcripts: (a) {hyp_a[0][0][0][:40]!r}  (b) {hyp_b[0][0][0][:40]!r}")
    for name, req, expect in (("(a)", req_a, expect_a), ("(b)", req_b, expect_b)):
        got, want = _kernel_vs_eager(f32, f"transducer greedy {name}", lambda: f32.nbest(req), expect)
        same = _ids(got) == _ids(want)
        print(f"  f32 transducer greedy {name}: ids identical to the eager path: {same} "
              f"({sum(len(i) for i in _ids(got))} tokens)")
        if not same:
            raise AssertionError(f"f32 transducer greedy {name} through the kernels disagrees with the eager path")
    out["greedy_a"] = call_profile(lambda: bf16.nbest(req_a), "bf16 transducer greedy (a) 32 x 4 s",
                                   host_events=False)
    out["greedy_b"] = call_profile(lambda: bf16.nbest(req_b), "bf16 transducer greedy (b) 24 x 20 s",
                                   host_events=False)
    out["greedy_launches"] = _path_counts("transducer greedy", ("K1", "K2", "K3"))

    for engine in (bf16, f32):
        _set_beam(engine, beam)
    print(f"transducer beam path: ALSD beam {beam}, prune 4, prefix merge, max_symbols = T, request (a)")
    _reset_counts()
    _exact_call(f"bf16 transducer beam {beam} (a) (first call)", lambda: bf16.nbest(req_a), expect_a)
    hyp = _exact_call(f"bf16 transducer beam {beam} (a)", lambda: bf16.nbest(req_a), expect_a)
    if len(hyp) != 32 or any(len(h) != beam or not np.isfinite(h[0][3]) for h in hyp):
        raise AssertionError(f"expected 32 n-best lists of {beam} with a finite 1-best score")
    hyp_k, hyp_e = _kernel_vs_eager(f32, f"transducer beam {beam} (a)", lambda: f32.nbest(req_a), expect_a)
    stable, bad = envelope_gate(hyp_k, [hyp_e], MT_ATOL)
    _beam_margins(hyp_k, hyp_e)
    for u, reason in bad:
        print(f"    utterance {u}: {reason}")
    worst = max((abs(g[0][3] - w[0][3]) for g, w in zip(hyp_k, hyp_e) if g[0][2] == w[0][2]), default=0.0)
    print(f"  f32 transducer beam (a): 1-best equal to the eager path's on "
          f"{sum(g == w for g, w in zip(_ids(hyp_k), _ids(hyp_e)))}/32, max |1-best score diff| {worst:.3e}; "
          f"{len(bad)} beyond the gate ({MT_ATOL:g} or 8 ulps, near-tied swaps allowed)")
    if bad:
        raise AssertionError("f32 transducer beam through the kernels disagrees with the eager path")
    print(f"  sample 1-best: bf16 {hyp[0][0][0][:40]!r} ({hyp[0][0][3]:.3f})")
    out["beam_a"] = call_profile(lambda: bf16.nbest(req_a), f"bf16 transducer beam {beam} (a) 32 x 4 s",
                                 host_events=False)
    out["beam_launches"] = _path_counts("transducer beam", ("K2", "K3"))

    # bf16 weight storage at the config's own quantize_min_size (it picks the
    # prediction network's embedding, whose bf16 rows meet the f32 LSTM):
    # greedy and the beam through the kernels against the eager path on the
    # same quantised weights
    f32.quantize_asr_model, f32.quantize_dtype, f32._quantize_pending = True, "bfloat16", True
    print(f"transducer with quantize_dtype: bfloat16 (quantize_min_size {f32.quantize_min_size}), f32 model, "
          "request (a)")
    _set_beam(f32, 1)
    got, want = _kernel_vs_eager(f32, "bf16-stored transducer greedy (a)", lambda: f32.nbest(req_a), expect_a)
    same = _ids(got) == _ids(want)
    print(f"  bf16-stored transducer greedy (a): ids identical to the eager path: {same} "
          f"({sum(len(i) for i in _ids(got))} tokens)")
    if not same:
        raise AssertionError("the bf16-stored transducer's greedy ids through the kernels differ from the eager path")
    _set_beam(f32, beam)
    hyp_k, hyp_e = _kernel_vs_eager(f32, f"bf16-stored transducer beam {beam} (a)", lambda: f32.nbest(req_a),
                                    expect_a)
    stable, bad = envelope_gate(hyp_k, [hyp_e], MT_ATOL)
    _beam_margins(hyp_k, hyp_e)
    equal = sum(g == w for g, w in zip(_ids(hyp_k), _ids(hyp_e)))
    print(f"  bf16-stored transducer beam (a): 1-best equal to the eager path's on {equal}/32; "
          f"{len(bad)} beyond the gate ({MT_ATOL:g} or 8 ulps, near-tied swaps allowed)")
    if bad:
        raise AssertionError("the bf16-stored transducer beam through the kernels disagrees with the eager path")
    out["bf16_stored"] = {"greedy_tokens": sum(len(i) for i in _ids(got)), "beam_equal_1best": equal}
    return out


def maskctc_transducer_phase(device) -> dict:
    """Mask-CTC, the transducer, then each one's train micro-steps, the
    engines freed between them; returns each path's numbers and counts."""
    out = {}
    for name, phase in (("maskctc", maskctc_phase), ("transducer", transducer_phase),
                        ("maskctc_train", lambda d: family_train_phase("Mask-CTC", MASKCTC_CONFIG, d, seed=50)),
                        ("transducer_train", lambda d: family_train_phase("transducer", TRANSDUCER_CONFIG, d,
                                                                          seed=60))):
        t0 = time.perf_counter()
        out[name] = phase(device)
        torch.cuda.empty_cache()
        print(f"  ({name} phase: {time.perf_counter() - t0:.1f} s)")
    return out


# -------------------------------------------------------- encoder variants
#
# The encoders on the Branchformer base at the repo's widths (12 blocks,
# 256-d, 4 heads, 2048 FFN units, k = 31), seeded weights, the encoder
# kernels on, from the repo's YAML with only the encoder keys named: the
# Conformer ASR (K2 at (a), K1 at (b); no cgMLP, so no K3), the same with
# the legacy rel-pos (its built bias through K2 at (b), K1 never), the
# E-Branchformer (K2, K3), the conventional AVSR with Conformer stacks (K2
# 24), the Transformer (abs_pos + selfattn: no kernel, as in JAX), and the
# flagship with interCTC taps after layers 4 and 8 and audio-visual
# conditioning; each f32 call held to the eager path; a bf16 train
# micro-step of the Conformer and of the interCTC flagship. Readings: PERF.md.


def _variant_engine(path: str, device, dtype: str, encoder: str = None, lm: bool = False, **encoder_conf):
    """``_family_engine`` of the config at ``path`` with ``encoder`` (when
    given) and ``encoder_conf`` keys set, beam 10 (the beam phase's)."""
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(path)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.dtype = dtype
    if encoder is not None:
        cfg.encoder = encoder
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True, **encoder_conf)
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=10, nbest=2 if dtype == "float32" else 1)
    lm_cfg = None
    if lm:
        lm_cfg = load_config(LM_CONFIG)
        lm_cfg.token_list = os.path.join(ROOT, lm_cfg.token_list)
    return Speech2Text(cfg, lm_config=lm_cfg, rng_seed=0, device=device)


def _encoder_kernels(model, t: int, batch: int) -> dict:
    """The launches one encode of ``batch`` utterances at T frames must make:
    a rel-pos attention takes K1 when it may (the "latest" shift) and its
    bias would reach 32 MiB, else K2 (a key-mask attention); every cgMLP
    gate takes K3; no other attention launches a kernel."""
    from tailored_avsr_tpu_torch.ops.attention import FLASH_RELPOS_MIN_BIAS_BYTES, RelPositionMultiHeadedAttention
    from tailored_avsr_tpu_torch.ops.cgmlp import ConvolutionalSpatialGatingUnit

    k = {"K1": 0, "K2": 0, "K3": 0}
    for m in model.encoder.modules():
        if isinstance(m, RelPositionMultiHeadedAttention):
            big = batch * m.h * t * t * next(model.parameters()).element_size() >= FLASH_RELPOS_MIN_BIAS_BYTES
            k["K1" if big and not (m.legacy or m.zero_triu) else "K2"] += 1
        elif isinstance(m, ConvolutionalSpatialGatingUnit):
            k["K3"] += 1
    return k


def _variant_served(name: str, bf16, f32, requests: dict, expect: dict, weights: bool = False) -> dict:
    """The first bf16 call of each request (its launches ``expect[r]``), the
    f32 gate against the eager path, then three warm bf16 calls (median)
    and one profiled; returns the walls and busy times per request."""
    out = {}
    for r, req in requests.items():
        t0 = time.perf_counter()
        hyps = _family_serve(bf16, f"bf16 {name} request {r} (first call)", req, expect[r])
        out[r] = {"first_call_ms": (time.perf_counter() - t0) * 1e3}
        print(f"    sample transcript: {hyps[0][:40]!r}")
        _family_gate(f32, f"{name} request {r}", req, expect[r], weights=weights)
        out[r].update(greedy_profile(bf16, req, f"bf16 {name} request {r}", repeats=3))
    return out


def _variant_train(name: str, cfg, device, seed: int, smi: str) -> dict:
    """Two bf16 train micro-steps (``make_train_step``, autocast over f32
    master weights, 4 x 20 s) of ``cfg``: no kernel launched, every stat and
    the accumulated gradients finite, each BatchNorm's running statistics
    moved; the second micro-step's wall and the peak memory printed."""
    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    ts = cfg.training_settings
    tokens = load_token_list(cfg.token_list)
    model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(0), device=device, dtype=torch.float32)
    opt, _ = set_optimizer(ts, int(cfg.encoder_conf["output_size"]), 1, model.named_parameters())
    state = create_train_state(model, opt)
    make_batch = _train_batch if cfg.task == "avsr" else _asr_train_batch
    batches = [make_batch(seed + k, 4, 20.0, len(tokens), (250, 300), device) for k in range(2)]
    running = {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    step = make_train_step(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    walls, stats = [], {}
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = step(state, b)
        stats = {k: float(v) for k, v in out.items()}
        walls.append((time.perf_counter() - t0) * 1e3)
        if not all(np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"{name} train micro-step: stats not finite: {stats}")
    grads = state.optimizer.acc if state.optimizer.acc is not None else list(model.parameters())
    launches = _counts()
    now = model.state_dict()
    still = [k for k, v in running.items() if torch.equal(v, now[k])]
    print(f"  {name}: bf16 train micro-steps (4 x 20 s): losses finite ({stats['loss']:.2f}), "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(stats.items()) if k.startswith("loss_"))
          + f"; walls ms {walls[0]:.1f} (first), {walls[1]:.1f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {len(running)} BatchNorm "
          f"running statistics, {len(running) - len(still)} moved (card {smi})")
    if any(launches.values()) or not _finite(grads) or still:
        raise AssertionError(f"{name} train: launches {launches}, gradients finite {_finite(grads)}, "
                             f"running statistics not moved: {still[:4]}")
    return {"stats": stats, "micro_step_ms": walls, "peak_bytes": int(torch.cuda.max_memory_allocated()),
            "launches": launches}


def encoder_variants_phase(device, smi: str) -> tuple:
    """The encoder variants' paths in turn, counts set to 0 first, the
    engines freed between them; returns (numbers, the phase's launch
    counts)."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    out = {}
    req_a, req_b = _speech_request(1, 32, 4, "asr"), _speech_request(2, 24, 20, "asr")
    conformer = dict(encoder="conformer", cnn_module_kernel=31)
    _reset_counts()

    t0 = time.perf_counter()
    bf16 = _variant_engine(ASR_CONFIG, device, "bfloat16", lm=True, **conformer)
    f32 = _variant_engine(ASR_CONFIG, device, "float32", lm=True, **conformer)
    expect = {"(a)": _encoder_kernels(f32.model, 99, 32), "(b)": _encoder_kernels(f32.model, 499, 24)}
    print(f"Conformer ASR: 12 blocks, 256-d, k 31, rel-pos; expected launches a call {expect}")
    out["conformer"] = _variant_served("Conformer ASR", bf16, f32, {"(a)": req_a, "(b)": req_b}, expect)
    print("  Conformer ASR beam + 16-layer LM, beam 10, request (a)")
    _nbest(bf16, "bf16 Conformer ASR beam (first call)", req_a)
    hyp_f32 = _nbest(f32, "f32 Conformer ASR beam", req_a)
    before = _counts()["K4"]
    f32.fused_group_attend = False
    hyp_plain = _nbest(f32, "f32 Conformer ASR beam, plain group attend", req_a)
    f32.fused_group_attend = None
    if _counts()["K4"] != before:
        raise AssertionError("fused_group_attend: false launched the group-attend kernel")
    _held_against_plain(hyp_f32, hyp_plain, "K4")
    del bf16, f32
    out["conformer"]["phase_s"] = time.perf_counter() - t0

    cases = (
        ("Conformer ASR, rel_pos_type legacy", "conformer_legacy", ASR_CONFIG, dict(conformer, rel_pos_type="legacy"),
         {"(b)": req_b}),
        # the YAML's learned_ave would win over the registry's concat default,
        # and the E-Branchformer's conv merge runs under concat only
        ("E-Branchformer ASR (concat merge, merge conv k 3)", "e_branchformer", ASR_CONFIG,
         dict(encoder="e_branchformer", merge_method="concat"), {"(a)": req_a}),
        ("conventional AVSR, Conformer stacks", "conventional_conformer", CONVENTIONAL_CONFIG,
         dict(encoder_class_type="conformer"), {"(a)": _request(1, 32, 4)}),
        ("Transformer ASR (abs_pos, selfattn, relu: no Pallas kernel in JAX either)", "transformer", ASR_CONFIG,
         dict(encoder="transformer", attention_layer_type="selfattn", pos_enc_layer_type="abs_pos",
              ffn_activation_type="relu"), {"(a)": req_a}),
        ("flagship, interCTC after layers 4 and 8, audio-visual conditioning", "interctc", FLAGSHIP,
         dict(interctc_layer_idx=[4, 8], interctc_use_conditioning=True, audiovisual_interctc_conditioning=True),
         {"(a)": _request(1, 32, 4)}),
    )
    for title, key, path, conf, requests in cases:
        t0 = time.perf_counter()
        bf16 = _variant_engine(path, device, "bfloat16", **conf)
        f32 = _variant_engine(path, device, "float32", **conf)
        # encoder frames: the lip frames of an AVSR request, 99 / 499 from 4 s / 20 s of audio
        expect = {r: _encoder_kernels(f32.model, req["video"].shape[1] if "video" in req else
                                      {"(a)": 99, "(b)": 499}[r], _utterances(req)) for r, req in requests.items()}
        print(f"{title}: expected launches a call {expect}")
        out[key] = _variant_served(title, bf16, f32, requests, expect)
        out[key]["phase_s"] = time.perf_counter() - t0
        del bf16, f32
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = load_config(ASR_CONFIG)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.encoder = "conformer"
    cfg.encoder_conf = dict(cfg.encoder_conf, cnn_module_kernel=31)
    launches = _counts()
    out["conformer_train"] = _variant_train("Conformer ASR", cfg, device, 70, smi)
    cfg = _flagship_train_cfg(interctc_layer_idx=[4, 8], interctc_use_conditioning=True,
                              audiovisual_interctc_conditioning=True)
    cfg.model_conf = dict(cfg.model_conf, interctc_weight=0.3)
    out["interctc_train"] = _variant_train("flagship with interCTC (weight 0.3)", cfg, device, 80, smi)
    if not {"loss_interctc_layer4", "loss_interctc_layer8"} <= set(out["interctc_train"]["stats"]):
        raise AssertionError(f"the interCTC train step reported no tap losses: {out['interctc_train']['stats']}")
    out["train_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"  launches over the encoder variants' serving paths: {launches}")
    if min(launches[k] for k in ("K1", "K2", "K3", "K4", "K5")) <= 0:
        raise AssertionError(f"a kernel of the encoder variants' paths never launched: {launches}")
    return out, launches


# -------------------------------------------------------- decoder variants
#
# The other attention decoders on the flagship (the Sim-T and conv decoders
# from its decoder_conf: 6 blocks, 4 heads, 2048 units, 256-d; ``rnn`` and
# ``s4`` at the registry's defaults: 320 hidden, 1 layer, att_dim 320, 10 x
# 201-tap location conv; 6 blocks, d_state 64), each through the full-prefix
# beam with the 16-layer LM's full-prefix step (beam 10, ctc 0.1, lm 0.4) at
# 8 x 4 s: no decoder has a cache step, so K4 and the step write stay off
# these paths, as in JAX, and each call's encode launches K2 19 and K3 5;
# Mask-CTC over the Sim-T MLM decoder at (a) and (b); the RNN and VGG-RNN
# ASR encoders (no kernel, as in JAX) greedy at (a), the VGG-RNN with the
# LSTM decoder through the beam + LM at 8 x 4 s; two bf16 micro-steps each
# of the flagship with Sim-T and of the VGG-RNN ASR with the LSTM decoder.
# Each path is timed by its first call and a profiled one (no warm call);
# the conv decoders run in f32 alone, timed by their first call. Readings:
# PERF.md.
AR_DECODERS = ("sim_t", "lightweight_conv", "dynamic_conv", "lightweight_conv2d", "dynamic_conv2d", "rnn", "s4")
# the conv decoders run in f32 alone (the f32 first call timed, no profiled
# call): one engine and two calls each, to keep the script inside its limit
F32_ONLY = ("lightweight_conv", "dynamic_conv", "lightweight_conv2d", "dynamic_conv2d")
VARIANT_SCORE_ATOL = 1e-3  # f32 n-best scores through the kernels against the eager path's


def _decoder_cfg(path: str, dtype: str, decoder: str = None, encoder: str = None, **inference_conf):
    """The config at ``path`` (seeded weights follow from ``rng_seed``) with
    ``decoder`` / ``encoder`` swapped in: ``rnn`` and ``s4`` decoders and
    the RNN encoders at the registry's defaults, every other decoder from
    the YAML's decoder_conf; the encoder kernels on; beam 10."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(path)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.dtype = dtype
    if decoder is not None:
        cfg.decoder = decoder
        if decoder in ("rnn", "s4"):
            cfg.decoder_conf = {}
    if encoder is not None:
        cfg.encoder = encoder
        cfg.encoder_conf = {"output_size": 320}  # the registry's default, named for the optimizer's d_model
    else:
        cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True)
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=10, nbest=2 if dtype == "float32" else 1,
                              **inference_conf)
    return cfg


def _decoder_engine(path: str, device, dtype: str, lm: bool = True, **kw):
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.config import load_config

    lm_cfg = None
    if lm:
        lm_cfg = load_config(LM_CONFIG)
        lm_cfg.token_list = os.path.join(ROOT, lm_cfg.token_list)
    return Speech2Text(_decoder_cfg(path, dtype, **kw), lm_config=lm_cfg, rng_seed=0, device=device)


def _step_counter(engine) -> list:
    """Counts the decoder's full-prefix steps (one a beam step) in ``[0]``."""
    dec, calls = engine.model.decoder, [0]
    real = dec.score_step

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    dec.score_step = counted
    return calls


def _full_prefix_beam(name: str, bf16, f32, req: dict, expect: dict) -> dict:
    """A full-prefix beam path: the first call of the timed engine (``bf16``,
    or ``f32`` when ``bf16`` is None; launches ``expect``, steps counted),
    a profiled one of a ``bf16`` engine, then f32 through the kernels (the
    f32 first call, when it is the timed one) and on the eager path: n-best
    ids equal, scores within VARIANT_SCORE_ATOL."""
    timed, dt = (bf16, "bf16") if bf16 is not None else (f32, "f32")
    steps = _step_counter(timed)
    hyps, first = _exact_call_ms(f"{dt} {name} (first call)", lambda: timed.nbest(req), expect)
    out = {"dtype": dt, "steps": steps[0], "first_call_ms": first}
    print(f"    {steps[0]} beam steps; sample transcript {hyps[0][0][0][:40]!r}")
    if steps[0] <= 0 or not all(np.isfinite(h[3]) for hs in hyps for h in hs):
        raise AssertionError(f"{name}: {steps[0]} beam steps, scores {[h[0][3] for h in hyps]}")
    if bf16 is None:
        got, want = hyps, _eager_call(f32, name, lambda: f32.nbest(req))
    else:
        out.update(call_profile(lambda: bf16.nbest(req), f"{dt} {name}", repeats=0, host_events=False))
        got, want = _kernel_vs_eager(f32, name, lambda: f32.nbest(req), expect)
    same = [[h[2] for h in g] for g in got] == [[h[2] for h in w] for w in want]
    diff = max(abs(g[3] - w[3]) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    print(f"  f32 {name}: n-best ids equal to the eager path's: {same}; max |score diff| {diff:.3e} "
          f"(tol {VARIANT_SCORE_ATOL:g})")
    if not same:
        _beam_margins(got, want)
    if not same or diff > VARIANT_SCORE_ATOL:
        raise AssertionError(f"f32 {name}: the kernel path disagrees with the eager path")
    out["f32_max_score_diff"] = diff
    return out


def _hands_on_f32(engine, req: dict, name: str) -> None:
    """A bf16 model's RNN encoder hands f32 memory on, as flax's does (its
    LSTMs start from f32 carries); the CTC head's log-probs over it finite."""
    with torch.inference_mode():
        enc = engine.model.encode(*engine.inputs(req))[0]
        logp = engine.model.ctc.log_softmax(enc)
    print(f"  {name}: weights {engine.model.ctc.ctc_lo.weight.dtype}, encoder output {enc.dtype}")
    if engine.model.ctc.ctc_lo.weight.dtype != torch.bfloat16 or enc.dtype != torch.float32 \
            or not bool(torch.isfinite(logp).all()):
        raise AssertionError(f"{name}: the encoder hands on {enc.dtype}; the JAX encoder hands on f32")


def decoder_variants_phase(device, smi: str) -> tuple:
    """The decoder variants' and RNN encoders' paths in turn, counts set to 0
    first, the engines freed between them; returns (numbers, the phase's
    launch counts)."""
    out = {}
    req8, req_a, req_b = _request(3, 8, 4), _request(1, 32, 4), _request(2, 24, 20)
    encode = {"K2": 19, "K3": 5}  # the flagship encode at T = 100: 19 attention and 5 cgMLP layers
    _reset_counts()
    for decoder in AR_DECODERS:
        t0 = time.perf_counter()
        bf16 = None if decoder in F32_ONLY else _decoder_engine(FLAGSHIP, device, "bfloat16", decoder=decoder)
        f32 = _decoder_engine(FLAGSHIP, device, "float32", decoder=decoder)
        print(f"flagship + {decoder} decoder ({type(f32.model.decoder).__name__}) + 16-layer LM, full-prefix "
              f"beam 10 at 8 x 4 s; expected launches a call {encode} (no K4, no step write)")
        key = f"{decoder}_decoder"
        out[key] = _full_prefix_beam(f"{decoder} beam + LM 8 x 4 s", bf16, f32, req8, encode)
        out[key]["phase_s"] = time.perf_counter() - t0
        del bf16, f32
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bf16 = _decoder_engine(MASKCTC_CONFIG, device, "bfloat16", lm=False, decoder="sim_t")
    f32 = _decoder_engine(MASKCTC_CONFIG, device, "float32", lm=False, decoder="sim_t")
    print(f"Mask-CTC over the Sim-T MLM decoder ({type(f32.model.decoder).__name__}, V + 1 tokens), "
          f"{f32.maskctc_n_iterations} rounds: request (a) 32 x 4 s (K2 19, K3 5) and (b) 24 x 20 s (K1 19, K3 5)")
    first_a = _exact_call_ms("bf16 Sim-T Mask-CTC nbest (a) (first call)", lambda: bf16.nbest(req_a), encode)[1]
    first_b = _exact_call_ms("bf16 Sim-T Mask-CTC nbest (b) (first call)", lambda: bf16.nbest(req_b),
                             {"K1": 19, "K3": 5})[1]
    out["maskctc_sim_t"] = {"first_call_ms_a": first_a, "first_call_ms_b": first_b}
    out["maskctc_sim_t"].update(call_profile(lambda: bf16.nbest(req_a), "bf16 Sim-T Mask-CTC nbest (a)", repeats=0,
                                             host_events=False))
    got, want = _kernel_vs_eager(f32, "Sim-T Mask-CTC nbest (a)", lambda: f32.nbest(req_a), encode)
    print(f"  f32 Sim-T Mask-CTC (a): ids identical to the eager path's: {_ids(got) == _ids(want)}")
    if _ids(got) != _ids(want) or not any(_ids(got)):
        raise AssertionError("f32 Sim-T Mask-CTC through the kernels disagrees with the eager path")
    out["maskctc_sim_t"]["phase_s"] = time.perf_counter() - t0
    del bf16, f32
    torch.cuda.empty_cache()

    req_sa, req_s8 = _speech_request(1, 32, 4, "asr"), _speech_request(3, 8, 4, "asr")
    for encoder in ("rnn", "vgg_rnn"):
        t0 = time.perf_counter()
        bf16 = _decoder_engine(ASR_CONFIG, device, "bfloat16", lm=False, encoder=encoder)
        f32 = _decoder_engine(ASR_CONFIG, device, "float32", lm=False, encoder=encoder)
        enc = f32.model.encoder
        print(f"{encoder} ASR encoder ({enc.num_layers} bidirectional LSTM layers, {enc.output_size}-d"
              f"{', VGG2L' if enc.use_vgg else ''}) greedy at (a) 32 x 4 s: no kernel (none in JAX either)")
        t1 = time.perf_counter()
        hyps = _family_serve(bf16, f"bf16 {encoder} greedy (a) (first call)", req_sa, {})
        _hands_on_f32(bf16, req_sa, f"bf16 {encoder}")
        key = f"{encoder}_encoder"
        out[key] = {"first_call_ms": (time.perf_counter() - t1) * 1e3}
        print(f"    sample transcript {hyps[0][:40]!r}")
        _family_gate(f32, f"{encoder} greedy (a)", req_sa, {}, weights=False)
        out[key].update(greedy_profile(bf16, req_sa, f"bf16 {encoder} greedy (a)", repeats=0))
        out[key]["phase_s"] = time.perf_counter() - t0
        del bf16, f32
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bf16 = _decoder_engine(ASR_CONFIG, device, "bfloat16", encoder="vgg_rnn", decoder="rnn")
    f32 = _decoder_engine(ASR_CONFIG, device, "float32", encoder="vgg_rnn", decoder="rnn")
    print("VGG-RNN ASR + LSTM decoder + 16-layer LM, full-prefix beam 10 at 8 x 4 s: no kernel (none in JAX "
          "either)")
    _hands_on_f32(bf16, req_s8, "bf16 VGG-RNN")
    out["vgg_rnn_lstm_beam"] = _full_prefix_beam("VGG-RNN + LSTM decoder beam + LM 8 x 4 s", bf16, f32, req_s8, {})
    out["vgg_rnn_lstm_beam"]["phase_s"] = time.perf_counter() - t0
    del bf16, f32
    torch.cuda.empty_cache()
    launches = _counts()

    t0 = time.perf_counter()
    cfg = _flagship_train_cfg()
    cfg.decoder = "sim_t"
    out["sim_t_train"] = _variant_train("flagship + Sim-T decoder", cfg, device, 90, smi)
    cfg = _decoder_cfg(ASR_CONFIG, "float32", decoder="rnn", encoder="vgg_rnn")
    out["vgg_rnn_lstm_train"] = _variant_train("VGG-RNN ASR + LSTM decoder", cfg, device, 100, smi)
    out["train_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"  launches over the decoder variants' serving paths: {launches}")
    if min(launches[k] for k in ("K1", "K2", "K3")) <= 0 or any(launches[k] for k in ("K4", "K5", "K6")):
        raise AssertionError(f"the decoder variants' paths launched {launches}: K1-K3 each, and no K4, step "
                             "write or K6")
    return out, launches


# ----------------------------------------------------------- input side, streaming, PIT
#
# The last ASR-side modules at the ASR config's widths (12 blocks, 256-d, 4
# heads, 2048 units, the 6-layer decoder), seeded weights: the fused
# frontend (log-mel + a sliding window, both at hop 160, 100-d projections)
# with global MVN (statistics of a seeded corpus) or utterance MVN with
# norm_vars, and the linear pre-encoder (200 -> 80) and post-encoder
# (256 -> 256) around the Branchformer; the contextual-block encoders fed
# to the streamers in 640 ms chunks; the PIT model's micro-steps.
INPUT_SIDE_FUSED = {"frontends": [
    {"frontend_type": "default", "n_fft": 512, "win_length": 400, "hop_length": 160, "n_mels": 80},
    {"frontend_type": "sliding_window", "win_length": 400, "hop_length": 160}], "proj_dim": 100}
STREAM_ATOL = 1e-4  # streamed encoder frames against the offline encode (f32, TF32 off)
STREAM_CHUNK = 64  # feature frames a chunk: 640 ms at the 10 ms hop
BLOCK = {"block_size": 40, "hop_size": 16, "look_ahead": 16}
PIT_SWAP_RTOL = 1e-6
PIT_CARD_VS_CPU_RTOL = 1e-4


def _asr_variant_cfg(path: str, dtype: str, **keys):
    """The repo's config at ``path`` with the encoder kernels on, top-level
    ``keys`` set (``encoder_conf`` merged into the YAML's)."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(path)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.dtype = dtype
    cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True, **keys.pop("encoder_conf", {}))
    for key, value in keys.items():
        setattr(cfg, key, value)
    return cfg


def _input_side_engine(device, normalize: str):
    """The f32 ASR Branchformer with the fused frontend, ``normalize``
    (``global_mvn`` with its statistics taken over a seeded corpus of its
    own, 16 x 4 s, as ``compute_global_mvn_stats`` takes them, or
    ``utterance_mvn`` with ``norm_vars``) and the linear pre- and
    post-encoders."""
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = _asr_variant_cfg(ASR_CONFIG, "float32", frontend="fused", frontend_conf=INPUT_SIDE_FUSED,
                           normalize=normalize,
                           normalize_conf={} if normalize == "global_mvn" else {"norm_means": True, "norm_vars": True},
                           preencoder="linear", preencoder_conf={"output_size": 80},
                           postencoder="linear", postencoder_conf={"output_size": 256})
    engine = Speech2Text(cfg, rng_seed=0, device=device)
    if normalize == "global_mvn":
        with torch.inference_mode():
            feats, lens = engine.model.frontend(*engine.inputs(_speech_request(6, 16, 4, "asr")))
            f = feats[torch.arange(feats.shape[1], device=device)[None] < lens[:, None]].double()
            mean = f.mean(dim=0)
            std = torch.sqrt(torch.clamp((f * f).mean(dim=0) - mean * mean, min=1e-20))
        with torch.no_grad():
            engine.model.normalize.mean.copy_(mean)
            engine.model.normalize.std.copy_(std)
    return engine


def _full_request(seed: int, batch: int, seconds: int) -> dict:
    """An ASR request whose utterances all fill the buffer (a live stream
    has no padding)."""
    req = _speech_request(seed, batch, seconds, "asr")
    req["speech_lengths"][:] = seconds * 16000
    return req


def _offline_encode(engine, req: dict) -> tuple:
    """(features (B, T, F), encoder output, lengths) of a request: the
    frontend and normalisation, then the encoder over all its blocks."""
    model = engine.model
    with torch.inference_mode():
        feats, lens = model.frontend(*engine.inputs(req))
        feats, lens = model.normalize(feats, lens)
        enc, enc_lens, _ = model.encoder(feats, lens)
    return feats, enc, enc_lens


def _feed(streamer, feats: np.ndarray, out: list) -> list:
    """``feats`` to ``streamer`` in STREAM_CHUNK-frame chunks, then its flush;
    each call's result into ``out``; returns each call's wall ms."""
    walls = []
    streamer.reset(feats.shape[0])
    for a in list(range(0, feats.shape[1], STREAM_CHUNK)) + [None]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(streamer.finalize() if a is None else streamer.accept(feats[:, a:a + STREAM_CHUNK]))
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _stream_gate(name: str, engine, req: dict, seconds: float) -> dict:
    """``ContextualBlockStreamer`` over the request's features against the
    offline encode: frames within STREAM_ATOL, greedy ids equal; ms a
    chunk and the real-time factor."""
    from tailored_avsr_tpu_torch.decode.streaming import ContextualBlockStreamer

    feats, enc, _ = _offline_encode(engine, req)
    with torch.inference_mode():
        ids = engine.model.ctc.argmax(enc).cpu().numpy()
    parts = []
    walls = _feed(ContextualBlockStreamer(engine.model), feats.float().cpu().numpy(), parts)
    y = np.concatenate([p[0] for p in parts], axis=1)
    got_ids = np.concatenate([p[1] for p in parts], axis=1)
    err = float(np.abs(y - enc.float().cpu().numpy()).max()) if y.shape == tuple(enc.shape) else float("inf")
    same = got_ids.shape == ids.shape and bool((got_ids == ids).all())
    out = {"chunks": len(walls), "chunk_ms_median": float(np.median(walls)), "chunk_ms_max": float(max(walls)),
           "rtf": sum(walls) / 1e3 / seconds, "max_abs_err": err}
    print(f"  {name}: {len(walls)} chunks of {STREAM_CHUNK} frames (640 ms) + the flush; ms a chunk median "
          f"{out['chunk_ms_median']:.2f}, max {out['chunk_ms_max']:.2f}; real-time factor {out['rtf']:.4f}; "
          f"streamed frames {y.shape} vs offline {tuple(enc.shape)}, max |diff| {err:.3e} (tol {STREAM_ATOL:g}); "
          f"greedy ids equal: {same}")
    if err > STREAM_ATOL or not same:
        raise AssertionError(f"{name}: the streamed encoder disagrees with the offline encode")
    return out


def _timesync_stream_gate(engine, req: dict) -> dict:
    """``TimesyncStreamer`` at beam 10 against the offline time-synchronous
    search over the offline encode: each utterance's best ids equal."""
    from tailored_avsr_tpu_torch.decode.ctc_timesync import ctc_timesync_beam_search
    from tailored_avsr_tpu_torch.decode.streaming import TimesyncStreamer

    feats, enc, enc_lens = _offline_encode(engine, req)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, tlens, _, _ = ctc_timesync_beam_search(engine.model.ctc.log_softmax(enc), enc_lens, beam_size=10,
                                                     pre_beam=10, max_len=enc.shape[1])
        toks, tlens = toks.cpu().numpy(), tlens.cpu().numpy()
    offline_ms = (time.perf_counter() - t0) * 1e3
    want = [[int(x) for x in toks[i, 0, :tlens[i, 0]]] for i in range(toks.shape[0])]
    parts = []
    walls = _feed(TimesyncStreamer(engine.model, beam_size=10, pre_beam=10, max_tokens=enc.shape[1]),
                  feats.float().cpu().numpy(), parts)
    same = parts[-1] == want
    print(f"  TimesyncStreamer beam 10: best ids equal to the offline search's: {same} ({sum(map(len, want))} "
          f"tokens); stream {sum(walls):.1f} ms over {len(walls)} calls, offline search {offline_ms:.1f} ms")
    if not same or not any(want):
        raise AssertionError("TimesyncStreamer disagrees with the offline time-synchronous search")
    return {"stream_ms": sum(walls), "offline_ms": offline_ms}


def _transducer_stream_gate(device, req: dict) -> dict:
    """``TransducerStreamer`` on the transducer config with the
    contextual-block Conformer encoder against the offline greedy
    transducer decode over the offline encode: ids equal."""
    from tailored_avsr_tpu_torch.decode.streaming import TransducerStreamer
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.ops.attention import promoted_linear
    from tailored_avsr_tpu_torch.ops.rnnt import transducer_greedy_decode

    cfg = _asr_variant_cfg(TRANSDUCER_CONFIG, "float32", encoder="contextual_block_conformer", encoder_conf=dict(
        BLOCK, attention_layer_type="selfattn", pos_enc_layer_type="abs_pos"))
    engine = Speech2Text(cfg, rng_seed=0, device=device)
    model = engine.model
    feats, enc, enc_lens = _offline_encode(engine, req)
    joint, pred = model.joint_network, model.prediction_network
    with torch.inference_mode():
        toks, cnt = transducer_greedy_decode(promoted_linear(joint.lin_enc, enc), enc_lens, pred.step,
                                             joint.from_projected, pred.initial_state(enc.shape[0]))
        toks, cnt = toks.cpu().numpy(), cnt.cpu().numpy()
    want = [[int(x) for x in toks[i, :cnt[i]]] for i in range(toks.shape[0])]
    parts = []
    walls = _feed(TransducerStreamer(model), feats.float().cpu().numpy(), parts)
    got = [sum((p[i] for p in parts), []) for i in range(len(want))]
    same = got == want
    print(f"  TransducerStreamer ({type(model.encoder).__name__}, block_layer conformer): ids equal to the "
          f"offline greedy decode's: {same} ({sum(map(len, want))} tokens); stream {sum(walls):.1f} ms over "
          f"{len(walls)} calls")
    if not same or not any(want):
        raise AssertionError("TransducerStreamer disagrees with the offline greedy transducer decode")
    return {"stream_ms": sum(walls)}


def _pit_cfg():
    """``model: pit_espnet`` on ``transformer_multispkr``: the ASR config's
    12 blocks as the shared layers, 2 speaker stacks of 2 layers."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    cfg = load_config(ASR_CONFIG)
    cfg.token_list = os.path.join(ROOT, cfg.token_list)
    cfg.model, cfg.encoder = "pit_espnet", "transformer_multispkr"
    cfg.encoder_conf = dict(cfg.encoder_conf, num_blocks_sd=2, num_inf=2)
    cfg.model_conf = dict(cfg.model_conf, num_inf=2, num_ref=2)
    return cfg


def _pit_batch(seed: int, batch: int, seconds: float, vocab: int, device) -> tuple:
    """``_asr_train_batch`` with two seeded reference transcripts an
    utterance: text (B, 2, L) and lengths (B, 2)."""
    audio, lens, text0, len0 = _asr_train_batch(seed, batch, seconds, vocab, (250, 300), device)
    _, _, text1, len1 = _asr_train_batch(seed + 1000, batch, seconds, vocab, (200, 300), device)
    width = max(text0.shape[1], text1.shape[1])
    text = torch.stack([F.pad(x, (0, width - x.shape[1]), value=-1) for x in (text0, text1)], dim=1)
    return audio, lens, text, torch.stack([len0, len1], dim=1)


def _pit_phase(device, smi: str) -> dict:
    """PIT at full width: two bf16 micro-steps (4 x 20 s, autocast over f32
    master weights): finite losses and gradients, no kernel; then, f32, the
    loss with the two references swapped (within PIT_SWAP_RTOL) and the
    card against the CPU (loss and gradient norm, PIT_CARD_VS_CPU_RTOL)."""
    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    cfg = _pit_cfg()
    tokens = load_token_list(cfg.token_list)
    model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(0), device=device, dtype=torch.float32)
    opt, _ = set_optimizer(cfg.training_settings, int(cfg.encoder_conf["output_size"]), 1, model.named_parameters())
    state = create_train_state(model, opt)
    batch = _pit_batch(40, 4, 20.0, len(tokens), device)
    step = make_train_step(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    walls, stats = [], {}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = step(state, batch)
        stats = {k: float(v) for k, v in out.items()}
        walls.append((time.perf_counter() - t0) * 1e3)
        if not all(np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"PIT micro-step: stats not finite: {stats}")
    grads = state.optimizer.acc if state.optimizer.acc is not None else [p.grad for p in model.parameters()]
    launched = {k: v - before[k] for k, v in _counts().items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"  PIT ({type(model.encoder).__name__}: 12 shared + 2 x 2 speaker layers, 2 references an utterance) "
          f"bf16 micro-steps 4 x 20 s: walls ms {', '.join(f'{w:.1f}' for w in walls)}; loss {stats['loss']:.2f}, "
          f"loss_ctc {stats['loss_ctc']:.2f}, loss_att {stats['loss_att']:.2f}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; gradients finite {_finite(grads)}; launches {launched} (card {smi})")
    if not _finite(grads) or any(launched.values()):
        raise AssertionError("PIT micro-steps: gradients not finite or a kernel launched")
    model.eval()
    with torch.no_grad():
        audio, lens, text, tlens = batch
        loss = float(model(audio, lens, text, tlens)[0])
        swapped = float(model(audio, lens, text[:, [1, 0]], tlens[:, [1, 0]])[0])
    rel = abs(swapped - loss) / abs(loss)
    print(f"  f32 PIT loss {loss:.6f}, references swapped {swapped:.6f} (rel {rel:.2e}, tol {PIT_SWAP_RTOL:g})")
    if rel > PIT_SWAP_RTOL:
        raise AssertionError("the PIT loss moved when the references were swapped")
    del state, model, opt
    torch.cuda.empty_cache()
    results = {}
    for dev in (torch.device("cpu"), device):
        m = build_model(cfg, tokens, generator=torch.Generator().manual_seed(1), device=dev, dtype=torch.float32)
        b = _pit_batch(41, 2, 4.0, len(tokens), dev)
        loss_d, _ = m(*b)
        loss_d.backward()
        norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in m.parameters() if p.grad is not None]))
        results[dev.type] = (float(loss_d.detach()), float(norm))
    (l_cpu, n_cpu), (l_gpu, n_gpu) = results["cpu"], results["cuda"]
    dl, dn = abs(l_gpu - l_cpu) / abs(l_cpu), abs(n_gpu - n_cpu) / abs(n_cpu)
    print(f"  f32 PIT card vs CPU (full width, 2 x 4 s, eval): loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {dl:.2e}), "
          f"gradient norm {n_gpu:.6f} vs {n_cpu:.6f} (rel {dn:.2e}); tol {PIT_CARD_VS_CPU_RTOL:g}")
    if dl > PIT_CARD_VS_CPU_RTOL or dn > PIT_CARD_VS_CPU_RTOL:
        raise AssertionError("f32 PIT on the card disagrees with the CPU")
    return {"micro_step_ms": walls, "peak_bytes": int(peak), "stats": stats, "swap_rel": rel,
            "card_vs_cpu": {"loss_rel": dl, "grad_norm_rel": dn}}


def input_side_streaming_phase(device, smi: str) -> tuple:
    """The input side (fused frontend, global MVN or utterance MVN with
    norm_vars, linear pre/post-encoders) on the ASR Branchformer: f32
    greedy at (a) 32 x 4 s (K2 12, K3 12) and (b) 24 x 20 s (K1 12, K3 12)
    held to the eager path; the contextual-block Transformer and Conformer
    encoders streamed at 8 x 20 s against their offline encodes, the
    time-synchronous and transducer streamers against their offline
    searches (no kernel: plain MHA, as in JAX); PIT's micro-steps. Returns
    (numbers, the phase's launch counts)."""
    from tailored_avsr_tpu_torch.inference import Speech2Text

    out = {}
    req_a, req_b = _speech_request(1, 32, 4, "asr"), _speech_request(2, 24, 20, "asr")
    expect_a, expect_b = {"K2": 12, "K3": 12}, {"K1": 12, "K3": 12}
    _reset_counts()
    for normalize in ("global_mvn", "utterance_mvn"):
        t0 = time.perf_counter()
        engine = _input_side_engine(device, normalize)
        label = "global MVN" if normalize == "global_mvn" else "utterance MVN norm_vars"
        print(f"ASR input side: fused (log-mel + sliding window, hop 160, 2 x 100-d) -> {label} -> linear "
              f"pre-encoder 200 -> 80 -> Branchformer -> linear post-encoder 256 -> 256, f32")
        _family_gate(engine, f"input side, {label}, request (a) 32 x 4 s", req_a, expect_a)
        _family_gate(engine, f"input side, {label}, request (b) 24 x 20 s", req_b, expect_b)
        out[normalize] = {"phase_s": time.perf_counter() - t0}
        del engine
        torch.cuda.empty_cache()
    out["input_side_launches"] = _path_counts("input side", ("K1", "K2", "K3"))

    req = _full_request(4, 8, 20)
    for encoder in ("contextual_block_transformer", "contextual_block_conformer"):
        t0 = time.perf_counter()
        cfg = _asr_variant_cfg(ASR_CONFIG, "float32", encoder=encoder, encoder_conf=dict(
            BLOCK, attention_layer_type="selfattn", pos_enc_layer_type="abs_pos"))
        engine = Speech2Text(cfg, rng_seed=0, device=device)
        print(f"streaming: {encoder} (block 40, hop 16, look-ahead 16, abs_pos), 8 x 20 s in 640 ms chunks, f32")
        before = _counts()
        out[encoder] = _stream_gate(f"ContextualBlockStreamer, {encoder}", engine, req, 20.0)
        if encoder == "contextual_block_transformer":
            out[encoder]["timesync"] = _timesync_stream_gate(engine, req)
        launched = {k: v - before[k] for k, v in _counts().items()}
        if any(launched.values()):
            raise AssertionError(f"the contextual-block path launched {launched}: its attention is plain MHA")
        out[encoder]["phase_s"] = time.perf_counter() - t0
        del engine
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["transducer_stream"] = _transducer_stream_gate(device, req)
    out["transducer_stream"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launches = _counts()
    t0 = time.perf_counter()
    out["pit"] = _pit_phase(device, smi)
    out["pit"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out, launches


# ----------------------------------------------------------- serving modes
#
# The engine's other decode modes on the flagship + 16-layer LM at request
# (a): K4 over a cache of the other float type (both new type pairs), the
# append and segmented cache protocols against the ancestry protocol, the
# time-synchronous CTC beam, n-gram fusion (full, part, in the time-sync
# beam), qint8 weights, the full-prefix LM (ctc_weight 1.0) and streamed
# input. A bf16 cache under the f32 model rounds each step's columns, and
# the plain group attend rounds its weights and output, to bf16, where K4
# sums in f32: the f32 run is held to the spread of sound code, the plain
# twin un-noised and under NOISE_SEEDS (``envelope_gate``), with a score
# tolerance of one bf16 rounding of the attend's output carried over the
# steps (2e-2, K6's). Readings: PERF.md.
SCORE_ATOL["K4 bf16 cache"] = 2e-2
# the plain version rounds the own column's q.k product (a bf16 pair) or the
# weights and the product over the cache (a bf16 cache) to bf16 where the
# kernel keeps f32: K4 bf16's tolerance, on the f32 output
TOL[("group_attend_mixed", torch.float32)] = TOL[("group_attend", torch.bfloat16)]
MODES_ATOL = 1e-3  # append / segmented scores against the ancestry protocol's (f32)


@contextlib.contextmanager
def _engine_set(engine, **attrs):
    """``engine`` with attributes set for a block (the decode-time choices:
    cache protocol and dtype, decode mode, n-gram, the beam config), then
    restored."""
    old = {k: getattr(engine, k) for k in attrs}
    for k, v in attrs.items():
        setattr(engine, k, v)
    try:
        yield engine
    finally:
        for k, v in old.items():
            setattr(engine, k, v)


def _mode_call(engine, name: str, batch: dict, k4_layers: int = 0, beam: bool = True, pairs: dict = None):
    """One ``nbest`` call whose launches must be those of the flagship's
    encode at T = 100 (K2 19, K3 5) and, for a beam over group caches, K4 on
    ``k4_layers`` layers (0: the plain group attend) of every step and the
    step write once a step (the combining launches of K4 counted apart);
    no other kernel. ``pairs``: K4's launches a step by (query, cache)
    dtypes, asserted too. Prints its wall time."""
    from tailored_avsr_tpu_torch.ops import group_attend as ga

    before, combines = _counts(), ga.group_attend_anc.combines
    pairs_before = collections.Counter(ga.group_attend_anc.pairs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = engine.nbest(batch)
    wall = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in _counts().items()}
    combines = ga.group_attend_anc.combines - combines
    steps = got["K5"]
    want = {k: 0 for k in got}
    want.update(K2=19, K3=5)
    if beam:
        want.update(K4=k4_layers * steps + combines, K5=steps)
    print(f"  {name}: {wall * 1e3:.1f} ms wall, {steps} beam steps, launches "
          f"{({k: v for k, v in got.items() if v})}" + (f" ({combines} combining)" if combines else ""))
    if got != want or (beam and steps <= 0):
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    if pairs is not None:
        by_pair = {f"{str(q)[6:]} q, {str(c)[6:]} cache": n
                   for (q, c), n in (ga.group_attend_anc.pairs - pairs_before).items()}
        print(f"    K4 launches by type pair: {by_pair}")
        if by_pair != {p: n * steps for p, n in pairs.items()}:
            raise AssertionError(f"{name}: K4 type pairs {by_pair}, expected {pairs} a step")
    if len(hyps) != _utterances(batch) or not all(np.isfinite(h[0][3]) for h in hyps):
        raise AssertionError(f"{name}: expected {_utterances(batch)} n-best lists with a finite 1-best")
    return hyps


def _eager_run(engine, name: str, batch: dict):
    """``nbest`` with every kernel off (the encoder's K1-K3 and the group
    attend; the step write is bit-exact) -> the hypotheses."""
    before = _counts()
    _set_kernels(engine.model, False)
    try:
        with _engine_set(engine, fused_group_attend=False):
            hyps = engine.nbest(batch)
    finally:
        _set_kernels(engine.model, True)
    launched = {k: v - before[k] for k, v in _counts().items() if k not in ("K5",) and v != before[k]}
    print(f"  {name}: eager path, launches {launched or 'none but the step write'}")
    if launched:
        raise AssertionError(f"{name}: the eager path launched {launched}")
    return hyps


def _same_ids(got, want, what: str) -> None:
    same = _ids(got) == _ids(want)
    print(f"  {what}: 1-best ids identical: {same} ({sum(len(i) for i in _ids(got))} tokens)")
    if not same:
        _beam_margins(got, want)
        raise AssertionError(f"{what}: the ids differ")


def _k4_mixed_phase(device) -> dict:
    """K4's two new type pairs (bf16 queries over an f32 cache, f32 queries
    over a bf16 cache) against the plain version at the decoder's and the
    LM's shapes (batch 32, beam 10, Lc 104, H 4 and 8) at pos 53 and 103 and
    a narrowed width: error, kernel and plain ms, bound; returns the H = 8,
    pos 53 results by pair."""
    from tailored_avsr_tpu_torch.ops import group_attend as ga

    gen = torch.Generator(device=device).manual_seed(5)
    b, km, lc, dk = 32, 10, 104, 64
    out = {}
    for q_dt, c_dt, tag in ((torch.bfloat16, torch.float32, "bf16 q, f32 cache"),
                            (torch.float32, torch.bfloat16, "f32 q, bf16 cache")):
        for h in (4, 8):
            k, v = (torch.randn(b, h, km, lc, dk, generator=gen, device=device).to(c_dt) for _ in range(2))
            q, k_new, v_new = (torch.randn(b, h, km, dk, generator=gen, device=device).to(q_dt) for _ in range(3))
            anc = torch.randint(0, km, (b, km, lc), generator=gen, device=device, dtype=torch.int32)
            for pos, width in ((53, None), (103, None), (103, 32)):
                args = (k, v, q, k_new, v_new, anc, pos)
                got = ga.group_attend_anc(*args, width=width)
                want = ga.group_attend_anc_plain(*args, width=width)
                if got.dtype != torch.float32 or want.dtype != torch.float32:
                    raise AssertionError(f"K4 {tag}: output {got.dtype}, plain {want.dtype}: expected float32")
                shape = f"B={b} H={h} K={km} Lc={lc} pos={pos}" + (f" width={width}" if width else "")
                err = _compare(f"K4 group_attend_anc {tag} {shape}", "group_attend_mixed", got, want)
                row_bytes = 2 * dk * torch.finfo(c_dt).bits // 8
                bound = _group_attend_bound(anc, pos, width, row_bytes, (q, k_new, v_new, got), h, q_dt)
                r = _result(err, cold_time_ms(lambda: ga.group_attend_anc(*args, width=width)),
                            cold_time_ms(lambda: ga.group_attend_anc_plain(*args, width=width)), bound)
                if h == 8 and pos == 53 and width is None:
                    out[tag] = r
    return out


def _char_arpa(directory: str, tokens: list) -> str:
    """A character trigram ARPA counted from seeded text over the letters
    of the token list, words joined by ``<space>``."""
    from tailored_avsr_tpu_torch.decode.ngram import write_arpa

    rs = np.random.RandomState(7)
    letters = [t for t in tokens if len(t) == 1]
    sents = []
    for _ in range(400):
        words = [[letters[i] for i in rs.randint(0, len(letters), rs.randint(1, 8))] for _ in range(rs.randint(2, 9))]
        sents.append([tok for j, w in enumerate(words) for tok in (["<space>"] if j else []) + w])
    path = os.path.join(directory, "char3.arpa")
    write_arpa(path, sents)
    return path


def _copy_overlap(prof) -> dict:
    """Host-to-device copies of a profiled run: their device ms and the
    share of it during which a kernel ran on the device at the same time."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    copies = [(e.time_range.start, e.time_range.end) for e in events if "HtoD" in e.name]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if "Memcpy" not in e.name and "Memset" not in e.name)
    total = sum(b - a for a, b in copies)
    covered = 0.0
    for a, b in copies:
        for s, e in kernels:
            covered += max(0.0, min(b, e) - max(a, s))
    return {"h2d_copies": len(copies), "h2d_ms": total / 1e3,
            "overlap_share": min(1.0, covered / total) if total else 0.0}


def _stream_check(engine, device) -> dict:
    """``device_normalize`` with float audio: four batches through
    ``stream`` against four ``device_put_batch`` + ``nbest`` calls (equal
    results), both walls, and one profiled stream's overlap of its
    host-to-device copies with compute."""
    batches = []
    for seed in (11, 12, 13, 14):
        r = _request(seed, 32, 4)
        batches.append(dict(r, audio=(r["audio"].astype(np.float32) / 32768.0)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [engine.nbest(engine.device_put_batch(b)) for b in batches]
    per_batch = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [res for _, res in engine.stream(batches, nbest=True)]
    streamed = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError("stream disagrees with per-batch nbest calls")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        list(engine.stream(batches, nbest=True))
        torch.cuda.synchronize()
    ov = _copy_overlap(prof)
    print(f"  stream of 4 batches (32 x 4 s, float audio uploaded as int16): results equal to 4 nbest calls; "
          f"wall {streamed:.1f} ms streamed, {per_batch:.1f} ms as 4 put + nbest calls; profiled stream: "
          f"{ov['h2d_copies']} host-to-device copies, {ov['h2d_ms']:.3f} ms, {ov['overlap_share']:.3f} of it "
          "under a kernel")
    return {"streamed_wall_ms": streamed, "per_batch_wall_ms": per_batch, **ov}


def _plain_envelope(engine, req, name: str) -> list:
    """The plain twin's runs for ``envelope_gate``: ``engine`` with the plain
    group attend, un-noised and under NOISE_SEEDS (relative noise 1e-6 in
    f32 on each step's new columns, which a cache of the other type
    rounds)."""
    from tailored_avsr_tpu_torch import inference as inf_mod

    write = inf_mod.write_beam_step
    with _engine_set(engine, fused_group_attend=False):
        runs = [_mode_call(engine, f"{name}, plain group attend", req, 0)]
        for seed in NOISE_SEEDS:
            gen = torch.Generator(device=engine.device).manual_seed(seed)

            def noisy(leaves, pos, gen=gen):
                def jitter(x):
                    return x.float() * (1 + 1e-6 * torch.randn(x.shape, generator=gen, device=x.device))
                return write([(ck, cv, jitter(kn), jitter(vn)) for ck, cv, kn, vn in leaves], pos)

            with mock.patch.object(inf_mod, "write_beam_step", noisy):
                runs.append(_mode_call(engine, f"  plain + noise seed {seed}", req, 0))
    return runs


def _envelope_gate_k4(hyp, runs, what: str) -> None:
    """``hyp`` (through K4) held to the plain twin's ``runs`` by
    ``envelope_gate`` at SCORE_ATOL["K4 bf16 cache"]; the fixed gate's
    reading printed beside it."""
    _against_plain(hyp, runs[0], "K4 bf16 cache", f"{what} (fixed gate, printed)")
    stable, bad = envelope_gate(hyp, runs, SCORE_ATOL["K4 bf16 cache"])
    for u, reason in bad:
        print(f"    utterance {u}: {reason}")
    print(f"  {what} against the plain twin's envelope ({len(runs)} runs): {stable}/{len(hyp)} "
          f"stable, {len(bad)} beyond the gate ({SCORE_ATOL['K4 bf16 cache']:g} or 8 ulps)")
    if bad:
        raise AssertionError(f"{what} falls outside the plain twin's envelope")


def _quantized_f32_cache_phase(device, req, layers: int) -> dict:
    """The bf16 model over f32 caches with its weights and the LM's
    quantised (``qint8``, then ``bfloat16`` storage; ``quantize_min_size``
    4096), nbest 2: K4 on every cached layer of every step (each model's
    first layer on the bf16-query pair, past it f32, as flax promotes), held
    to the plain twin's envelope; bf16 walls and a profiled call."""
    out = {}
    for qdtype in ("qint8", "bfloat16"):
        engine = _beam_engine(device, "bfloat16", nbest=2, cache_dtype="float32", quantize_asr_model=True,
                              quantize_lm=True, quantize_dtype=qdtype)
        name = f"bf16 model, {qdtype} weights, f32 caches"
        hyp = _mode_call(engine, f"{name} (first call)", req, layers,
                         pairs={"bfloat16 q, float32 cache": 2, "float32 q, float32 cache": layers - 2})
        _envelope_gate_k4(hyp, _plain_envelope(engine, req, name), f"{name}, K4")
        out[qdtype] = call_profile(lambda: engine.nbest(req), f"bf16 {name}", repeats=3, host_events=False)
        del engine
        torch.cuda.empty_cache()
    return out


def serving_modes_phase(device) -> tuple:
    """Every decode mode of the engine at full width (flagship + 16-layer
    LM, beam 10, request (a) unless named), counts set to 0 first: each
    mode's first call and launch counts, and the f32 gates. (The modes'
    warm walls and profiled calls went to the benchmark that is to time
    the serving modes.) Returns (numbers, the path's launch counts)."""
    import dataclasses as dc

    from tailored_avsr_tpu_torch.decode.ngram import NgramScorer
    from tailored_avsr_tpu_torch.utils.quantize import quantized_payloads

    print("K4's new type pairs against the plain version (decoder H=4, LM H=8):")
    out = {"k4_mixed": _k4_mixed_phase(device)}
    req = _request(1, 32, 4)
    t0 = time.perf_counter()
    bf16 = _beam_engine(device, "bfloat16")
    f32 = _beam_engine(device, "float32", nbest=2)
    print(f"  two engines built (model + LM, seeded): {time.perf_counter() - t0:.1f} s")
    layers = len(bf16.model.decoder.decoders) + len(bf16.lm.encoder.encoders)
    walls = {}
    print(f"serving modes: flagship + 16-layer LM, beam 10, request (a) 32 x 4 s ({layers} cached layers)")
    _reset_counts()
    # mixed cache dtypes: K4 on every decoder and LM layer of every step
    # (past each model's first self-attention a bf16 model over f32 caches
    # runs in f32, as flax promotes: its first layers take the new pair)
    with _engine_set(bf16, cache_dtype=torch.float32):
        _mode_call(bf16, "bf16 model, f32 caches (first call)", req, layers,
                   pairs={"bfloat16 q, float32 cache": 2, "float32 q, float32 cache": layers - 2})
    with _engine_set(f32, cache_dtype=torch.bfloat16):
        hyp = _mode_call(f32, "f32 model, bf16 caches", req, layers, pairs={"float32 q, bfloat16 cache": layers})
        _envelope_gate_k4(hyp, _plain_envelope(f32, req, "f32 model, bf16 caches"), "f32 K4 over bf16 caches")

    # cache protocols: append and segmented against the ancestry protocol (f32)
    anc = _mode_call(f32, "f32 anc", req, layers)
    for name, attrs in (("append", {"cache_protocol": "append"}), ("segments 4", {"cache_segments": 4})):
        with _engine_set(f32, **attrs):
            hyps = _mode_call(f32, f"f32 {name}", req, beam=False)
        bad = sum(g[0][2] != w[0][2] or abs(g[0][3] - w[0][3]) > _score_tol(w[0][3], MODES_ATOL)
                  for g, w in zip(hyps, anc))
        worst = max(abs(g[0][3] - w[0][3]) for g, w in zip(hyps, anc))
        print(f"  f32 {name} against anc: {len(anc) - bad}/{len(anc)} utterances with equal 1-best ids and "
              f"scores within {MODES_ATOL:g} (max |diff| {worst:.3e})")
        if bad:
            raise AssertionError(f"the {name} protocol disagrees with the ancestry protocol")
    for name, attrs in (("append", {"cache_protocol": "append"}), ("segments 4", {"cache_segments": 4})):
        with _engine_set(bf16, **attrs):
            _mode_call(bf16, f"bf16 {name} (first call)", req, beam=False)

    # time-sync: the CTC beam, decoder and LM rescoring
    for engine, dt in ((bf16, "bf16"), (f32, "f32")):
        with _engine_set(engine, decode_mode="timesync"):
            got = _mode_call(engine, f"{dt} time-sync (first call)", req, beam=False)
            if dt == "f32":
                _same_ids(got, _eager_run(engine, "f32 time-sync", req), "f32 time-sync, kernels vs eager")

    # n-gram fusion: full, part, and in the time-sync beam
    with tempfile.TemporaryDirectory() as tmp:
        arpa = _char_arpa(tmp, bf16.token_list)
        ngram = NgramScorer(arpa, bf16.token_list, device=device)
    print(f"  n-gram: seeded character trigram, table {tuple(ngram.table.shape)} on the card, weight 0.3")
    for name, attrs, k4 in (("n-gram full", {"ngram_mode": "full"}, layers),
                            ("n-gram part", {"ngram_mode": "part"}, layers),
                            ("time-sync + n-gram", {"decode_mode": "timesync"}, 0)):
        for engine, dt in ((bf16, "bf16"), (f32, "f32")):
            with _engine_set(engine, ngram=ngram, ngram_weight=0.3, **attrs):
                got = _mode_call(engine, f"{dt} {name} (first call)", req, k4, beam=bool(k4))
                if dt == "f32":
                    _same_ids(got, _eager_run(engine, f"f32 {name}", req), f"f32 {name}, kernels vs eager")

    # the full-prefix LM: ctc_weight 1.0, the decoder's anc step selecting, 8 x 4 s
    small = _request(4, 8, 4)
    with _engine_set(bf16, beam_config=dc.replace(bf16.beam_config, ctc_weight=1.0)):
        _mode_call(bf16, "bf16 full-prefix LM, ctc_weight 1.0, 8 x 4 s (first call)", small,
                   len(bf16.model.decoder.decoders))

    # streamed input under device_normalize (the time-sync engine: short decodes)
    with _engine_set(bf16, decode_mode="timesync", quantize_audio=True):
        out["stream"] = _stream_check(bf16, device)

    # qint8 weights (quantize_asr_model + quantize_lm), last: quantising is for good
    qbf16, qf32 = bf16, f32
    for engine in (qbf16, qf32):
        engine.quantize_asr_model = engine.quantize_lm = engine._quantize_pending = True
        engine.quantize_dtype = "qint8"
    _mode_call(qbf16, "bf16 qint8 weights (first call)", req, layers)
    got = _mode_call(qf32, "f32 qint8 weights", req, layers)
    payloads = [p for m in (qf32.model, qf32.lm) for p, _ in quantized_payloads(m).values()]
    q_bytes = sum(p.numel() * p.element_size() for p in payloads)
    f32_bytes = sum(p.numel() * 4 for p in payloads)
    on_card = all(p.is_cuda and p.dtype == torch.int8 for p in payloads)
    print(f"  f32 qint8: {len(payloads)} quantised leaves, {q_bytes / 2 ** 20:.2f} MiB of int8 payload on the card "
          f"against {f32_bytes / 2 ** 20:.2f} MiB in f32 (ratio {q_bytes / f32_bytes:.4f})")
    if not on_card or 4 * q_bytes != f32_bytes:
        raise AssertionError("the quantised leaves are not a quarter of their f32 bytes on the card")
    _same_ids(got, _eager_run(qf32, "f32 qint8 weights", req), "f32 qint8 weights, kernels vs eager")
    out["qint8_payload_mib"] = q_bytes / 2 ** 20
    del bf16, f32, qbf16, qf32
    torch.cuda.empty_cache()
    # quantised weights on the bf16 model over f32 caches: dequantised once a
    # call, the f32 copy of each model made from the dequantised weights
    walls["quantised, bf16 model, f32 caches"] = _quantized_f32_cache_phase(device, req, layers)
    launches = _counts()
    print(f"  launches over the serving modes: {launches}")
    if min(launches[k] for k in ("K2", "K3", "K4", "K5")) <= 0:
        raise AssertionError(f"a kernel of the serving modes never launched: {launches}")
    out["walls"] = walls
    return out, launches



# ------------------------------------------------------------------ recipe
#
# The rest of the paper's recipe at full width, seeded weights and data:
# the 16-layer LM trained by ``lm_main`` and served through the beam (K4,
# the step write), ``remat`` and a config ``init`` in the flagship's train
# step, ``study_adaptive_fusion`` (K1 or K2, and K3), ``get_val_accs`` with
# ``average_model``, and ``compute_flops``. Readings: PERF.md.
RECIPE_LOSS_ATOL = 1e-5  # remat against the plain micro-step: the same forward
# gradients' relative L2 gap: CUDA's ctc_loss and cuDNN's backward add in a
# run-dependent order (PERF.md section 7)
RECIPE_GRAD_RTOL = 1e-3
# fusion weights through the kernels vs the plain path, (atol, rtol): f32
# 1e-4; a bf16 weight is a softmax output rounded to bf16 (a step of 2^-8,
# 3.9e-3, at weights in [0.5, 1)) after twelve layers whose bf16 attention
# kernels are held to their plain versions at TOL's bf16 attention
# tolerance, which holds the weights too; the counts beyond 2e-3 and beyond
# one bf16 step are printed
FUSION_TOL = {"bfloat16": TOL[("attention", torch.bfloat16)], "float32": (1e-4, 0.0)}


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126))) - 7)
_SPANISH_WORDS = ("EL", "LA", "DE", "QUE", "Y", "EN", "UN", "UNA", "LOS", "LAS", "POR", "CON", "PARA", "COMO",
                  "PERO", "MAS", "TODO", "ESTE", "OTRO", "CUANDO", "MUY", "SIN", "TIEMPO", "CASA", "DÍA", "AÑO",
                  "NIÑO", "MAÑANA", "CIUDAD", "GOBIERNO", "PAÍS", "MUNDO", "VIDA", "HOMBRE", "MUJER", "PARTE",
                  "AQUÍ", "TAMBIÉN", "DESPUÉS", "SIEMPRE", "NUNCA", "AHORA", "HABLAR", "ESCRIBIR", "CAMINO")


class _GradRecorder:
    """An optimizer stand-in for the train step: keeps the first micro-step's
    gradients on the host and clears them, as ``Optimizer.step`` does."""

    def __init__(self, model):
        self.model, self.grads, self.acc = model, None, None

    def step(self):
        if self.grads is None:
            self.grads = {n: p.grad.detach().cpu() for n, p in self.model.named_parameters() if p.grad is not None}
        self.model.zero_grad(set_to_none=True)


def _spanish_lines(rs, n: int, lo: int = 80, hi: int = 200) -> list:
    """``n`` lines of seeded Spanish words, each ``lo``-``hi`` characters."""
    lines = []
    for _ in range(n):
        target, words = rs.randint(lo, hi + 1), []
        while len(" ".join(words)) < target:
            words.append(_SPANISH_WORDS[rs.randint(len(_SPANISH_WORDS))])
        lines.append(" ".join(words)[:hi].strip())
    return lines


def _lm_trainer(device, tmp: str) -> tuple:
    """``lm_main.main`` on the card: the 16-layer 512-d LM of
    ``configs/LM/lm-spanish.yaml``, 2 epochs over 256 lines (64 seeded
    Spanish lines of 80-200 characters, four times), batch 32, Noam warmup
    100; each train step timed. Returns (numbers, the averaged .pth)."""
    from tailored_avsr_tpu_torch import lm_main

    path = os.path.join(tmp, "text.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(_spanish_lines(np.random.RandomState(70), 64) * 4) + "\n")
    walls = []
    make = lm_main.make_lm_train_step

    def timed_make(lm, optimizer, generator):
        step = make(lm, optimizer, generator)

        def timed(tokens, lengths):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(tokens, lengths)
            float(loss)
            walls.append((time.perf_counter() - t0) * 1e3)
            return loss
        return timed

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(lm_main, "make_lm_train_step", timed_make):
        res = lm_main.main(["--config-file", LM_CONFIG, "--training-dataset", path, "--output-dir",
                            os.path.join(tmp, "lm_exp"), "--device", "cuda", "--yaml-overrides",
                            "training_settings:epochs:2", "training_settings:average_epochs:2",
                            "training_settings:warmup_steps:100",
                            f"token_list:{os.path.join(ROOT, 'tokenizers/char/spanish.txt')}"])
    peak = torch.cuda.max_memory_allocated()
    losses, ppl = res["losses"], res["ppl"]
    warm = walls[1:]
    out = {"epoch_losses": losses, "val_ppl": ppl, "steps": len(walls), "step_ms_median": float(np.median(warm)),
           "step_ms_min": float(min(warm)), "step_ms_max": float(max(warm)), "peak_bytes": int(peak)}
    print(f"  LM trainer: {len(walls)} steps of 32 lines, epoch losses {losses}, val ppl {ppl}; warm step ms "
          f"median {out['step_ms_median']:.1f} (min {out['step_ms_min']:.1f}, max {out['step_ms_max']:.1f}); "
          f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or not os.path.exists(res["average"]):
        raise AssertionError(f"the LM trainer's losses {losses} are not finite and falling, or no average")
    return out, res["average"]


def _trained_lm_beam(device, lm_path: str) -> dict:
    """The averaged LM in ``Speech2Text`` beside the flagship: beam 10 at
    request (a) in f32, K4 on all 22 cached layers of every step and the
    step write once a step (the trained LM lets the early exit end the
    search before 100 steps), its 1-best held to the plain group
    attend's."""
    from tailored_avsr_tpu_torch.ops import cache_update as cu

    req = _request(1, 32, 4)
    engine = _beam_engine(device, "float32", nbest=2)
    engine.load_lm_checkpoint(lm_path)
    layers = len(engine.model.decoder.decoders) + len(engine.lm.encoder.encoders)
    steps = cu.write_step_columns.launches
    hyp = _mode_call(engine, "f32 beam 10 + the trained LM (a) 32 x 4 s", req, layers)
    steps = cu.write_step_columns.launches - steps
    with _engine_set(engine, fused_group_attend=False):
        plain = _mode_call(engine, "f32 beam 10 + the trained LM (a), plain group attend", req, 0)
    _held_against_plain(hyp, plain, "K4")
    bf16 = _beam_engine(device, "bfloat16")
    bf16.load_lm_checkpoint(lm_path)
    out = {"bf16_wall_ms": nbest_walls(bf16, req, "bf16 beam 10 + the trained LM (a)"),
           "f32_steps": steps, "k4_launches": layers * steps, "sample_1best": hyp[0][0][0][:60]}
    del engine, bf16
    torch.cuda.empty_cache()
    return out


def _remat_step_runs(cfg, tokens, device, batch, remat: bool, steps: int) -> dict:
    """``steps`` micro-steps (bf16 autocast) of a freshly seeded model on one
    batch, the optimizer a ``_GradRecorder``: the first step's loss and
    gradients, the BatchNorm statistics after, peak memory, warm walls."""
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.train.loop import TrainState, make_train_step

    model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(0), device=device,
                        dtype=torch.float32)
    rec = _GradRecorder(model)
    state = TrainState(step=0, model=model, optimizer=rec, schedule=None, generator=torch.Generator().manual_seed(7))
    step = make_train_step(torch.bfloat16, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)[1]["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"loss": losses[0], "grads": rec.grads, "peak_bytes": int(torch.cuda.max_memory_allocated()),
           "walls": walls, "bn": {k: v.detach().cpu() for k, v in model.state_dict().items() if "running" in k}}
    del model, rec, state
    torch.cuda.empty_cache()
    return out


def _remat_check(device) -> dict:
    """The flagship micro-step at 4 x 20 s in bf16 autocast, ``remat`` off
    then on from the same weights and seed: loss within RECIPE_LOSS_ATOL,
    gradients' relative L2 gap within RECIPE_GRAD_RTOL, BatchNorm
    statistics equal, peak memory lower with ``remat``; then both at
    16 x 20 s for their peak memory."""
    from tailored_avsr_tpu_torch.inference import load_token_list

    cfg = _flagship_train_cfg()
    tokens = load_token_list(cfg.token_list)
    batch = _train_batch(80, 4, 20, len(tokens), (250, 300), device)
    plain = _remat_step_runs(cfg, tokens, device, batch, False, 4)
    remat = _remat_step_runs(cfg, tokens, device, batch, True, 4)
    num = sum(float((remat["grads"][k] - g).double().pow(2).sum()) for k, g in plain["grads"].items())
    den = sum(float(g.double().pow(2).sum()) for g in plain["grads"].values())
    gap = (num / den) ** 0.5
    bn_equal = all(torch.equal(remat["bn"][k], v) for k, v in plain["bn"].items())
    d_loss = abs(remat["loss"] - plain["loss"])
    out = {"loss_diff": d_loss, "grad_rel_l2": gap, "bn_equal": bn_equal}
    for name, r in (("plain", plain), ("remat", remat)):
        out[name] = {"peak_bytes": r["peak_bytes"], "step_ms_median": float(np.median(r["walls"][1:]))}
    print(f"  remat vs plain micro-step (flagship, 4 x 20 s, bf16 autocast): loss {remat['loss']:.6f} vs "
          f"{plain['loss']:.6f} (|diff| {d_loss:.2e}, tol {RECIPE_LOSS_ATOL:g}); gradients' relative L2 gap "
          f"{gap:.3e} (tol {RECIPE_GRAD_RTOL:g}); BatchNorm statistics equal: {bn_equal}")
    print(f"  peak memory plain {plain['peak_bytes'] / 2 ** 30:.2f} GiB, remat {remat['peak_bytes'] / 2 ** 30:.2f} "
          f"GiB; warm micro-step ms median plain {out['plain']['step_ms_median']:.1f}, remat "
          f"{out['remat']['step_ms_median']:.1f}")
    if d_loss > RECIPE_LOSS_ATOL or gap > RECIPE_GRAD_RTOL or not bn_equal:
        raise AssertionError("the remat micro-step disagrees with the plain one")
    if remat["peak_bytes"] >= plain["peak_bytes"]:
        raise AssertionError("remat did not lower the micro-step's peak memory")
    big = _train_batch(81, 16, 20, len(tokens), (250, 300), device)
    for name, on in (("plain", False), ("remat", True)):
        r = _remat_step_runs(cfg, tokens, device, big, on, 1)
        out[f"{name}_16x20s_peak_bytes"] = r["peak_bytes"]
        print(f"  {name} micro-step at 16 x 20 s: {r['walls'][0]:.1f} ms (first call), peak memory "
              f"{r['peak_bytes'] / 2 ** 30:.2f} GiB; loss {r['loss']:.3f}")
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"the {name} micro-step at 16 x 20 s is not finite")
    return out


def _init_check(device) -> dict:
    """The flagship built under ``init: xavier_uniform`` on the card (the
    seeded init, then ``initialize`` as ``avsr_main`` applies it): two
    micro-steps, finite."""
    from tailored_avsr_tpu_torch.train.loop import make_train_step
    from tailored_avsr_tpu_torch.utils.initialize import initialize, scheme_std

    cfg = _flagship_train_cfg()
    cfg.init = "xavier_uniform"
    state, tokens = _train_state(cfg, device, seed=3)
    initialize(state.model, cfg.init, torch.Generator().manual_seed(3))
    w = state.model.decoder.decoders[0].feed_forward.w_1.weight.detach()
    std, want = float(w.std()), scheme_std(cfg.init, w.shape[1], w.shape[0])
    batch = _train_batch(82, 4, 20, len(tokens), (250, 300), device)
    losses = _train_micro_steps(state, make_train_step(torch.bfloat16), [batch], 1, 2)
    print(f"  init {cfg.init}: a decoder FFN kernel's std {std:.5f} (scheme {want:.5f}); two micro-steps, losses "
          f"{losses[0]:.3f}, {losses[1]:.3f}, finite")
    if abs(std / want - 1) > 0.05:
        raise AssertionError(f"init {cfg.init} did not redraw the kernels")
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "ffn_kernel_std": std}


def _fusion_check(device) -> dict:
    """``study_adaptive_fusion``'s forward on the flagship, bf16 and f32,
    through the kernels at (b) 24 x 20 s (K1 19, K3 5 a call) and (a) 32 x 4
    s (K2 19, K3 5), masks none and audio, against the plain path (kernels
    off) on the same inputs: FUSION_TOL."""
    from tailored_avsr_tpu_torch import study_adaptive_fusion as saf

    out = {}
    shapes = (("(b) 24 x 20 s", _request(2, 24, 20), {"K1": 19, "K3": 5}),
              ("(a) 32 x 4 s", _request(1, 32, 4), {"K2": 19, "K3": 5}))
    for dtype in ("bfloat16", "float32"):
        engine = _greedy_engine(device, dtype, True)
        for name, req, expect in shapes:
            for mask in ("none", "audio"):
                args = engine.inputs(saf.masked(req, mask))
                what = f"{dtype} fusion weights {name}, mask {mask}"
                got = _exact_call(what, lambda: saf.fusion_weights(engine.model, *args), expect)
                _set_kernels(engine.model, False)
                try:
                    want = _exact_call(f"{what}, plain path", lambda: saf.fusion_weights(engine.model, *args), {})
                finally:
                    _set_kernels(engine.model, True)
                atol, rtol = FUSION_TOL[dtype]
                d = {k: (got[k].float() - want[k].float()).abs() for k in got}
                diff = max(float(v.max()) for v in d.values())
                over = sum(int((d[k] > atol + rtol * want[k].float().abs()).sum()) for k in d)
                mean = float(got["acoustic_weight"].float().mean())
                print(f"    max |weight diff| {diff:.3e} (tol {atol:g} + {rtol:g} |w|: {over} beyond; beyond 2e-3: "
                      f"{sum(int((v > 2e-3).sum()) for v in d.values())}, beyond one bf16 step: "
                      f"{sum(int((d[k] > _bf16_step(want[k])).sum()) for k in d)} of {2 * d['acoustic_weight'].numel()}); "
                      f"mean acoustic weight {mean:.4f}")
                if over:
                    raise AssertionError(f"{what}: the kernels' fusion weights differ from the plain path's")
                out[f"{dtype} {name} {mask}"] = {"max_diff": diff, "mean_acoustic_weight": mean}
        del engine
        torch.cuda.empty_cache()
    return out


def _synthetic_split(root: str, tokens: list, n: int = 8) -> str:
    """A split CSV of ``n`` seeded utterances of 2-4 s (int16 WAV at 16 kHz,
    96x96 lip crops in an .npz, one-line Spanish transcripts), written with
    ``csv`` (the card's machine has no pandas)."""
    import csv

    from scipy.io import wavfile

    rs = np.random.RandomState(90)
    rows = []
    for i in range(n):
        frames = rs.randint(50, 101)
        paths = {k: os.path.join(root, f"s{i}.{ext}") for k, ext in (("wav", "wav"), ("lips", "npz"), ("txt", "txt"))}
        wavfile.write(paths["wav"], 16000, np.clip(rs.randn(frames * 640) * 3000, -32768, 32767).astype(np.int16))
        np.savez(paths["lips"], data=(rs.rand(frames, 96, 96) * 250).astype(np.float32))
        with open(paths["txt"], "w", encoding="utf-8") as f:
            f.write(_spanish_lines(rs, 1, 10, 40)[0] + "\n")
        rows.append({"database": "synthetic", "sampleID": f"s{i}", "nframes": frames, "wav_path": paths["wav"],
                     "lips_path": paths["lips"], "transcription_path": paths["txt"], "delimiter": ",",
                     "text_enc": "utf-8"})
    path = os.path.join(root, "split.csv")
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return path


def _val_accs_check(device, tmp: str) -> dict:
    """Two seeded flagship checkpoints decoded over a synthetic split by
    ``get_val_accs`` on the card (``Speech2Text.stream``, the config's beam
    10, K1-K3 on), then ``average_model --val-accs --top-k 2``: the mean of
    the two state dicts."""
    from tailored_avsr_tpu_torch import average_model, get_val_accs
    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.train.checkpoint import save_model

    cfg = _flagship_train_cfg()
    tokens = load_token_list(cfg.token_list)
    exp = os.path.join(tmp, "exp")
    for epoch in (1, 2):
        model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(epoch), device=device)
        save_model(model, os.path.join(exp, "models", f"model_{epoch:03d}.pth"))
        del model
    split = _synthetic_split(tmp, tokens)
    overrides = [f"token_list:{cfg.token_list}", "encoder_conf:use_fused_csgu:true"]
    before = _counts()
    t0 = time.perf_counter()
    rows = get_val_accs.main(["--config-file", FLAGSHIP, "--yaml-overrides", *overrides, "--validation-dataset",
                              split, "--exp-dir", exp, "--output-dir", os.path.join(tmp, "va"), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    print(f"  get_val_accs: {len(rows)} checkpoints over 8 utterances in {wall:.1f} s, launches {launched}; "
          f"rows {[(r['epoch'], r['wer'], r['cer']) for r in rows]}")
    if sorted(r["epoch"] for r in rows) != [1, 2] or not launched.get("K4") or \
            not (launched.get("K1", 0) + launched.get("K2", 0)) or not launched.get("K3"):
        raise AssertionError("get_val_accs did not decode both checkpoints through the kernels")
    avg = os.path.join(tmp, "avg.pth")
    average_model.main(["--val-accs", os.path.join(tmp, "va", "val_accs.csv"), "--top-k", "2", "--output", avg])
    got = torch.load(avg, weights_only=True)
    a, b = (torch.load(os.path.join(exp, "models", f"model_{e:03d}.pth"), weights_only=True) for e in (1, 2))
    same = all(torch.equal(got[k], ((a[k].double() + b[k].double()) / 2).to(a[k].dtype)) for k in a)
    print(f"  average_model --val-accs --top-k 2: the mean of the two state dicts: {same}")
    if not same or set(got) != set(a):
        raise AssertionError("average_model's output is not the mean of the two checkpoints")
    return {"rows": [{k: r[k] for k in ("epoch", "wer", "cer")} for r in rows], "wall_s": wall,
            "launches": launched}


def _flops_check(device) -> dict:
    """``compute_flops`` on the flagship at (a) 32 x 4 s and (b) 24 x 20 s."""
    from tailored_avsr_tpu_torch import compute_flops

    out = {}
    for name, seconds, batch in (("(a) 32 x 4 s", 4, 32), ("(b) 24 x 20 s", 20, 24)):
        r = compute_flops.main(["--config-file", FLAGSHIP, "--yaml-overrides",
                                f"token_list:{os.path.join(ROOT, 'tokenizers/char/spanish.txt')}", "--seconds",
                                str(seconds), "--batch-size", str(batch), "--device", "cuda"])
        out[name] = {"parameters": r["parameters"], "encode_gflop": r["flops"] / 1e9}
    torch.cuda.empty_cache()
    return out


def recipe_phase(device, smi: str) -> tuple:
    """The recipe's remaining entry points on the card, counts set to 0
    first; returns (numbers, the phase's launch counts)."""
    out = {}
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("lm_trainer", None), ("lm_beam", None), ("remat", _remat_check), ("init", _init_check),
                         ("study_adaptive_fusion", _fusion_check),
                         ("val_accs", lambda d: _val_accs_check(d, tmp)), ("compute_flops", _flops_check)):
            t0 = time.perf_counter()
            print(f"recipe: {name}")
            if name == "lm_trainer":
                out[name], lm_path = _lm_trainer(device, tmp)
            elif name == "lm_beam":
                out[name] = _trained_lm_beam(device, lm_path)
            else:
                out[name] = fn(device)
            out[name]["phase_s"] = time.perf_counter() - t0
            print(f"  ({name}: {out[name]['phase_s']:.1f} s; card {smi})")
    launches = _counts()
    print(f"  launches over the recipe phase: {launches}")
    if min(launches[k] for k in ("K1", "K2", "K3", "K4", "K5")) <= 0:
        raise AssertionError(f"a kernel of the recipe's paths never launched: {launches}")
    return out, launches

# ---------------------------------------------------------------- parallel
#
# Data and tensor parallelism over torch.distributed (``parallel/``) on the
# one card: two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
# device), spawned, each its own process (the launch counts are per
# process, so each rank sends its own back); then a one-rank NCCL group in
# this process, the backend of a machine with several cards. Readings:
# PERF.md.
PARALLEL_BN_RTOL = 1e-5  # BatchNorm running statistics, of each tensor's largest entry
PARALLEL_REQUEST = (21, 4, 4)  # seed, utterances, seconds: two utterances a rank
PARALLEL_TRAIN = (31, 4, 20.0)  # the global batch of the micro-steps: 2 x 20 s a rank


def _parallel_train_cfg():
    """The flagship's train config, every rate 0, one micro-step an update."""
    cfg = _flagship_train_cfg()
    _zero_rates(cfg)
    cfg.training_settings = dict(cfg.training_settings, accum_grad=1)
    return cfg


def _parallel_step(cfg, tokens, batch, device, grid, dtype=None, keep=False) -> dict:
    """One micro-step of the seeded flagship over ``grid`` (None: one
    process): the gradient the optimizer consumed (gathered to the
    single-process names), the BatchNorm statistics after it and a digest
    of every parameter (for the replicas' identity); ``keep``: the state."""
    import hashlib

    from tailored_avsr_tpu_torch.parallel.mesh import replicate
    from tailored_avsr_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(0), device=device,
                        dtype=torch.float32)
    tp = None
    if grid is not None:
        replicate(model)
        if grid.model > 1:
            tp = apply_tensor_parallel(model, grid.model, grid.model_rank, grid.model_group)
    opt, _ = set_optimizer(cfg.training_settings, int(cfg.encoder_conf.get("output_size", 256)), 1,
                           model.named_parameters())
    if tp is not None:
        opt.set_tensor_parallel(tp.is_split, grid.model_group)
    state = create_train_state(model, opt, tp=tp)
    grads, real = {}, opt.step

    def capture():
        for name, p in zip(opt.trainable, opt.params):
            grads[name] = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        return real()

    opt.step = capture
    step = make_train_step(dtype, grid=grid)
    _, stats = step(state, batch)
    opt.step = real
    loss = float(stats["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"parallel micro-step: loss {loss}")
    sd = model.state_dict()  # the single-process layout (tensor-parallel shards gathered)
    h = hashlib.sha256()
    for k, v in sorted(sd.items()):
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    out = {"grads": grads if tp is None else tp.full_named(grads), "loss": loss, "digest": h.hexdigest(),
           "bn": {k: v.clone() for k, v in sd.items() if "running_" in k}}
    if keep:
        out["state"] = state
    return out


def _grad_rel(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradients over every parameter."""
    if set(got) != set(want):
        raise AssertionError(f"gradients of other parameters: {sorted(set(got) ^ set(want))[:4]}")
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5


def _bn_rel(got: dict, want: dict) -> float:
    return max(float((got[k].double() - w.double()).abs().max()) / max(float(w.abs().max()), 1e-30)
               for k, w in want.items())


def _parallel_gates(name: str, got: dict, want: dict) -> dict:
    rel, bn = _grad_rel(got["grads"], want["grads"]), _bn_rel(got["bn"], want["bn"])
    print(f"  {name}: gradient relative L2 {rel:.3e} of the single-process global batch's (gate "
          f"{RECIPE_GRAD_RTOL:g}); BatchNorm statistics {bn:.3e} of each tensor's largest (gate "
          f"{PARALLEL_BN_RTOL:g}); loss {got['loss']:.6f} against {want['loss']:.6f}")
    if not rel <= RECIPE_GRAD_RTOL or not bn <= PARALLEL_BN_RTOL:
        raise AssertionError(f"{name}: the parallel gradient or statistics are not the global batch's")
    return {"grad_rel_l2": rel, "bn_rel": bn}


def _parallel_rank(rank: int, world: int, store: str, out_dir: str, device: str = "cuda:0") -> None:
    """One of the two ranks on cuda:0 (gloo): (a) the beam + LM served over
    the ranks, (b) the data-parallel micro-step in f32, then one in bf16,
    timed, (c) the tensor-parallel micro-step in f32. Rank 0 also runs the
    single-process references and holds the gates."""
    import torch.distributed as dist

    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.kernels import build
    from tailored_avsr_tpu_torch.parallel.mesh import all_gather_objects, make_grid
    from tailored_avsr_tpu_torch.train.loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        build.load()  # the library the parent built: found under the build lock, no compile
        out = {"rank": rank}
        # (a) serving: each rank decodes its two utterances, the results gathered in batch order
        engine = _beam_engine(device, "float32", nbest=2, data_parallel=True)
        req = _request(*PARALLEL_REQUEST)
        if rank == 0:  # the same engine's single-process calls on the whole batch
            want_greedy, want_nbest = engine._greedy(req), engine._nbest(req)
        _reset_counts()
        dist.barrier()  # the ranks' calls start together
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy = engine.greedy(req)
        t1 = time.perf_counter()
        nbest = engine.nbest(req)
        t2 = time.perf_counter()
        out["launches"] = _counts()
        out["serve_ms"] = {"greedy": (t1 - t0) * 1e3, "beam": (t2 - t1) * 1e3}
        counts = out["launches"]
        if min(counts["K1"] + counts["K2"], counts["K3"], counts["K4"], counts["K5"]) <= 0:
            raise AssertionError(f"rank {rank}: a kernel of the path never launched: {counts}")
        if rank == 0:
            worst = max(abs(g[3] - w[3]) for gh, wh in zip(nbest, want_nbest) for g, w in zip(gh, wh))
            same = greedy == want_greedy and all(
                [h[2] for h in gh] == [h[2] for h in wh]
                and all(abs(g[3] - w[3]) <= _score_tol(w[3], SCORE_ATOL["K4"]) for g, w in zip(gh, wh))
                for gh, wh in zip(nbest, want_nbest))
            print(f"  (a) f32 beam 10 + LM over 2 ranks, {len(req['audio'])} x {PARALLEL_REQUEST[2]} s: greedy and "
                  f"2-best ids equal to the single-process calls: {same}; scores max |diff| {worst:.3e} (gate "
                  f"{SCORE_ATOL['K4']:g})")
            if not same or len(nbest) != len(req["audio"]):
                raise AssertionError("the data-parallel engine disagrees with its single-process calls")
            out["serve_score_max_diff"] = worst
        del engine
        torch.cuda.empty_cache()

        # (b) data parallelism: the f32 micro-step against the single-process step on the global batch
        cfg = _parallel_train_cfg()
        tokens = load_token_list(cfg.token_list)
        seed, b, seconds = PARALLEL_TRAIN
        batch = _train_batch(seed, b, seconds, len(tokens), (int(12.5 * seconds), int(15 * seconds)), device)
        want = _parallel_step(cfg, tokens, batch, device, None) if rank == 0 else None
        if rank == 0:  # the reference of the parent's one-rank NCCL step too
            torch.save({"grads": {k: v.cpu() for k, v in want["grads"].items()},
                        "bn": {k: v.cpu() for k, v in want["bn"].items()}, "loss": want["loss"]},
                       os.path.join(out_dir, "reference.pt"))
        grid = make_grid(device)
        got = _parallel_step(cfg, tokens, batch, device, grid, keep=True)
        digests = all_gather_objects(got["digest"])
        if rank == 0:
            out["dp"] = _parallel_gates("(b) data-parallel f32 micro-step, 2 ranks", got, want)
            out["dp"]["replicas_identical"] = len(set(digests)) == 1
            print(f"  (b) the two replicas' parameters after the update bit-identical: {len(set(digests)) == 1}")
            if len(set(digests)) != 1:
                raise AssertionError("the data-parallel replicas differ after the update")
        state = got.pop("state")
        del got
        step = make_train_step(torch.bfloat16, grid=grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        _, stats = step(state, batch)
        loss = float(stats["loss"])
        torch.cuda.synchronize()
        out["bf16_step_ms"] = (time.perf_counter() - t0) * 1e3
        out["bf16_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        if not np.isfinite(loss):
            raise AssertionError(f"rank {rank}: bf16 data-parallel micro-step loss {loss}")
        # what the step's one gradient all-reduce costs alone: gloo sums CUDA tensors through the host
        flat = torch.zeros(sum(p.numel() for p in state.optimizer.params), device=device)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=grid.data_group)
        torch.cuda.synchronize()
        out["grad_all_reduce_ms"] = (time.perf_counter() - t0) * 1e3
        del state, flat
        torch.cuda.empty_cache()

        # (c) tensor parallelism: model_parallel 2, the gradient gathered
        tp_grid = make_grid(device, model_parallel=2)
        got = _parallel_step(cfg, tokens, batch, device, tp_grid)
        if rank == 0:
            out["tp"] = _parallel_gates("(c) tensor-parallel f32 micro-step, model_parallel 2", got, want)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_phase(device, smi: str) -> tuple:
    """(a)-(c) in two spawned ranks on the card over gloo, then (d) the
    data-parallel micro-step over a one-rank NCCL group here, each held to
    the single-process step. Returns (numbers, each rank's launch counts)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from tailored_avsr_tpu_torch.inference import load_token_list
    from tailored_avsr_tpu_torch.parallel.mesh import make_grid

    print("parallel phase: flagship, two ranks on cuda:0 over gloo (spawned), then a one-rank NCCL group")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_parallel_rank, args=(2, os.path.join(tmp, "gloo"), tmp), nprocs=2,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]
        spawn_s = time.perf_counter() - t0
        cfg = _parallel_train_cfg()
        tokens = load_token_list(cfg.token_list)
        seed, b, seconds = PARALLEL_TRAIN
        batch = _train_batch(seed, b, seconds, len(tokens), (int(12.5 * seconds), int(15 * seconds)), device)
        want = torch.load(os.path.join(tmp, "reference.pt"), weights_only=True)  # rank 0's single-process step
        want = {**want, "grads": {k: v.to(device) for k, v in want["grads"].items()},
                "bn": {k: v.to(device) for k, v in want["bn"].items()}}
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl')}", rank=0, world_size=1)
        try:
            got = _parallel_step(cfg, tokens, batch, device, make_grid(device))
        finally:
            dist.destroy_process_group()
        nccl = _parallel_gates("(d) data-parallel f32 micro-step, one-rank NCCL group", got, want)
        del got, want
        torch.cuda.empty_cache()
    r0 = ranks[0]
    out = {"serve_score_max_diff": r0["serve_score_max_diff"], "dp": r0["dp"], "tp": r0["tp"], "nccl_one_rank": nccl,
           "serve_ms": [r["serve_ms"] for r in ranks], "bf16_step_ms": [r["bf16_step_ms"] for r in ranks],
           "bf16_peak_gib": [r["bf16_peak_gib"] for r in ranks],
           "grad_all_reduce_ms": [r["grad_all_reduce_ms"] for r in ranks], "spawned_ranks_s": spawn_s, "card": smi}
    for r in ranks:
        print(f"  rank {r['rank']}: greedy {r['serve_ms']['greedy']:.1f} ms, beam {r['serve_ms']['beam']:.1f} ms "
              f"(2 of 4 utterances, both ranks on one card); the first bf16 micro-step {r['bf16_step_ms']:.1f} ms "
              f"(2 x 20 s, peak {r['bf16_peak_gib']:.2f} GiB), of which the gradient's all-reduce alone "
              f"{r['grad_all_reduce_ms']:.1f} ms; launches {r['launches']}")
    print(f"  the two ranks' work, spawn to exit: {spawn_s:.1f} s")
    return out, [r["launches"] for r in ranks]


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

    seconds = {}
    t0 = time.perf_counter()
    print("kernel phases (kernel vs plain version on the card):")
    phases = kernel_phases(device)
    phases.update(beam_kernel_phases(device))
    phases.update(probe_phase(device))
    seconds["kernel phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("visual stem (kernel vs plain version and the module chain on the card):")
    stem = visual_stem_phase(device)
    seconds["visual stem"] = time.perf_counter() - t0
    print(json.dumps({"visual_stem": stem, "card": smi}))
    t0 = time.perf_counter()
    launches = serve_phase(device)
    seconds["flagship greedy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
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
    seconds["flagship beam and int8 beam"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    modes, modes_launches = serving_modes_phase(device)
    seconds["serving modes"] = time.perf_counter() - t0
    print(f"  (serving modes phase: {seconds['serving modes']:.1f} s)")
    print(json.dumps({"serving_modes": {**modes, "card": smi}}))

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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = flagship_train_phase(device, smi)
    card_vs_cpu_phase(device)
    canary = learning_canary(device)
    seconds["flagship train"] = time.perf_counter() - t0
    train_launches, eval_launches = train.pop("train_launches"), train.pop("eval_launches")
    print(json.dumps({"train": {**train, "canary": canary}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family = branchformer_phase(device)
    seconds["branchformer"] = time.perf_counter() - t0
    family_launches = {
        "asr_greedy": family["asr"].pop("greedy_launches"), "asr_beam": family["asr"].pop("beam_launches"),
        "vsr_greedy": family["vsr"].pop("greedy_launches"),
        "conventional_greedy": family["conventional"].pop("greedy_launches"),
        "asr_train_steps": family["asr_train"].pop("launches"),
    }
    print(json.dumps({"branchformer": family}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mt = maskctc_transducer_phase(device)
    seconds["maskctc and transducer"] = time.perf_counter() - t0
    mt_launches = {
        "maskctc_nbest": mt["maskctc"].pop("launches"),
        "transducer_greedy": mt["transducer"].pop("greedy_launches"),
        "transducer_beam": mt["transducer"].pop("beam_launches"),
        "maskctc_train_steps": mt["maskctc_train"].pop("launches"),
        "transducer_train_steps": mt["transducer_train"].pop("launches"),
    }
    print(json.dumps({"maskctc_transducer": {**mt, "card": smi}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    variants, variants_launches = encoder_variants_phase(device, smi)
    seconds["encoder variants"] = time.perf_counter() - t0
    print(f"  (encoder variants phase: {seconds['encoder variants']:.1f} s)")
    print(json.dumps({"encoder_variants": {**variants, "card": smi}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    decoders, decoders_launches = decoder_variants_phase(device, smi)
    seconds["decoder variants"] = time.perf_counter() - t0
    print(f"  (decoder variants phase: {seconds['decoder variants']:.1f} s)")
    print(json.dumps({"decoder_variants": {**decoders, "card": smi}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    input_side, input_side_launches = input_side_streaming_phase(device, smi)
    seconds["input_side_streaming_phase"] = time.perf_counter() - t0
    print(f"  (input side and streaming phase: {seconds['input_side_streaming_phase']:.1f} s)")
    print(json.dumps({"input_side_streaming": {**input_side, "card": smi}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recipe, recipe_launches = recipe_phase(device, smi)
    seconds["recipe"] = time.perf_counter() - t0
    print(f"  (recipe phase: {seconds['recipe']:.1f} s)")
    print(json.dumps({"recipe": recipe, "card": smi}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parallel, parallel_launches = parallel_phase(device, smi)
    seconds["parallel"] = time.perf_counter() - t0
    print(f"  (parallel phase: {seconds['parallel']:.1f} s)")
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"phase_seconds": seconds, "card": smi}))

    kernels = []
    for key, (name, source, replaces) in sources.items():
        # launches: the flagship serving path's; the train path's beside them
        # (its train steps, then its one eval step); then the Branchformer
        # family's paths
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[key], **phases[key, "bf16"],
                        "launches_train_steps": train_launches[key], "launches_eval_step": eval_launches[key],
                        "launches_branchformer": {path: c[key] for path, c in family_launches.items()},
                        "launches_maskctc_transducer": {path: c[key] for path, c in mt_launches.items()},
                        "launches_serving_modes": modes_launches[key],
                        "launches_recipe": recipe_launches[key],
                        "launches_encoder_variants": variants_launches[key],
                        "launches_decoder_variants": decoders_launches[key],
                        "launches_input_side_streaming": input_side_launches[key],
                        "launches_parallel": {f"rank{r}": c[key] for r, c in enumerate(parallel_launches)},
                        **({"mixed_pairs": modes["k4_mixed"], "decoder_shape_h4": phases["K4 decoder", "bf16"]}
                           if key == "K4" else {}),
                        **({"one_layer": phases["K5 layer", "bf16"]} if key == "K5" else {}),
                        **({"f32": phases[key, "f32"]} if (key, "f32") in phases else {}),
                        **({"f32_eval_batch": phases["K2 eval batch", "f32"]} if key == "K2" else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:  # --ab PARENT_ROOT [--no-greedy]
        sys.exit(ab_main(sys.argv[2], greedy="--no-greedy" not in sys.argv))
    if sys.argv[1:2] == ["--k3-phases"]:
        sys.exit(k3_phases_main())
    if sys.argv[1:2] == ["--attention-phases"]:
        sys.exit(attention_phases_main())
    if sys.argv[1:2] == ["--heldout"]:  # --heldout SEED [SEED ...]
        sys.exit(heldout_main([int(a) for a in sys.argv[2:]]))
    sys.exit(main())
