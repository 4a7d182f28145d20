"""Operations and bytes of the work a cell asks for, from its shapes: the
layers' counts, which each family composes into the FLOPs of one call of
its entries (``harness/families/<family>.py``), and the kernels' costs.

FLOPs count the products (matmuls and convolutions, 2 per multiply-add) of
the reference's formulation at the padded shapes a call computes, with the
relative-position term as the T x T product it is; the FFT of the log-mel
frontend, the norms, activations and softmaxes are not counted. They count
the same work whatever implements it. Roofline bounds count each input
byte read once and each output byte written once, over the published
peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # float32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}
N_MELS, N_FREQS, HOP = 80, 257, 160


def _sub(n: int) -> int:
    return (n - 3) // 2 + 1


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def audio_frontend_flops(b: int, samples: int, d: int) -> float:
    """Mel projection and conv2d subsampling of (b, samples) audio."""
    t = samples // HOP + 1
    t1, f1 = _sub(t), _sub(N_MELS)
    t2, f2 = _sub(t1), _sub(f1)
    macs = b * t * N_FREQS * N_MELS + b * d * t1 * f1 * 9 + b * d * t2 * f2 * d * 9 + b * t2 * d * f2 * d
    return 2.0 * macs


def visual_frontend_flops(b: int, frames: int, crop: int = 88) -> float:
    """Conv3D stem and ResNet-18 trunk over (b, frames) 88x88 crops."""
    n = b * frames
    h = _conv_out(crop, 7, 2, 3)
    macs = n * 64 * h * h * 5 * 7 * 7
    h = _conv_out(h, 3, 2, 1)  # max-pool
    inplanes = 64
    for stage, planes in enumerate((64, 128, 256, 512), start=1):
        for i in range(2):
            stride = 2 if stage > 1 and i == 0 else 1
            ho = _conv_out(h, 3, stride, 1)
            macs += n * planes * ho * ho * inplanes * 9 + n * planes * ho * ho * planes * 9
            if stride != 1 or inplanes != planes:
                macs += n * planes * ho * ho * inplanes
            h, inplanes = ho, planes
    return 2.0 * macs  # the global pool is a mean, not counted


def attention_flops(b: int, t: int, d: int, h: int) -> float:
    """One rel-pos MHA over (b, t, d): q, k, v, out and the table's
    projection; the content, position and value products (T x T each)."""
    return 2.0 * (4 * b * t * d * d + (2 * t - 1) * d * d + 3 * b * t * t * d)


def ffn_flops(b: int, t: int, d: int, units: int) -> float:
    return 2.0 * 2 * b * t * d * units


def cgmlp_flops(b: int, t: int, d: int, units: int, kernel: int) -> float:
    return 2.0 * (b * t * d * units + b * (units // 2) * t * kernel + b * t * (units // 2) * d)


def pooled_weight_flops(b: int, t: int, d: int) -> float:
    return 2.0 * (b * t * d + b * t * d + b * d)


def audio_frames(samples: int) -> int:
    """Encoder frames of ``samples`` of audio: the log-mel frames, subsampled by 4."""
    return _sub(_sub(samples // HOP + 1))


def k1_cost(b: int, h: int, t: int, dk: int, dtype: str) -> Dict[str, float]:
    """K1 (flash attention with the rel-pos term) on (b, h, t, dk): 3 T x T
    products; reads q, k, v, the projected table (h, 2t-1, dk) and the
    key mask, writes the output."""
    e = BYTES[dtype]
    return {"flops": 6.0 * b * h * t * t * dk,
            "bytes": float(4 * b * h * t * dk * e + h * (2 * t - 1) * dk * e + 2 * h * dk * e + b * t)}


def bound_s(cost: Dict[str, float], dtype: str) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the type's peak, whichever is longer."""
    return max(cost["bytes"] / HBM_BYTES_PER_S, cost["flops"] / PEAK_FLOPS[dtype])


def _decoder_dims(cfg: Dict):
    dec = cfg["decoder_conf"]
    return cfg["encoder_conf"]["output_size"], dec["attention_heads"], dec["linear_units"], dec["num_blocks"]


def _lm_dims(lm_cfg: Dict):
    c = lm_cfg["lm_conf"]
    return c["att_unit"], c["head"], c["unit"], c["layer"], c["embed_unit"]


def beam_memory_flops(cfg: Dict, b: int, t: int) -> float:
    """The decoder's cross-attention K and V of the encoder output, once a call."""
    d, _, _, layers = _decoder_dims(cfg)
    return 2.0 * 2 * b * t * d * d * layers


def beam_step_flops(cfg: Dict, lm_cfg: Dict, b: int, t: int, pos: int) -> float:
    """One beam step at position ``pos`` (1-based) over b x beam hypotheses:
    the decoder (self-attention over ``pos`` columns, cross-attention over
    ``t`` frames, feed-forward, output layer) and the LM (embedding
    projection, self-attention over ``pos`` columns, feed-forward, output
    layer). The CTC prefix scores are no products and are not counted."""
    n = b * int(cfg["inference_conf"]["beam_size"])
    vocab = cfg["vocab"]
    d, _, units, layers = _decoder_dims(cfg)
    dec = layers * (4 * n * d * d + 2 * n * pos * d + 2 * n * d * d + 2 * n * t * d + 2 * n * d * units) + n * d * vocab
    total = 2.0 * dec
    if lm_cfg is not None and float(cfg["inference_conf"].get("lm_weight", 0.0)) > 0:
        d, _, units, layers, emb = _lm_dims(lm_cfg)
        lm = n * emb * d + layers * (4 * n * d * d + 2 * n * pos * d + 2 * n * d * units) + n * d * vocab
        total += 2.0 * lm
    return total


def k4_step_bound_s(cfg: Dict, lm_cfg: Dict, b: int, pos: int, dtype: str) -> float:
    """The bound of a beam step's group attends (K4, one a cached layer):
    each query's q . k and p . v over the ``pos - 1`` live columns; bytes of
    one ancestry path of K and V per utterance and head (the least any
    ancestry table needs), the queries, the step's columns, the output and
    the ancestry table's live columns."""
    k = int(cfg["inference_conf"]["beam_size"])
    n, live, e = b * k, max(0, pos - 1), BYTES[dtype]
    d, h, _, count = _decoder_dims(cfg)
    layers = [(h, d, count)]  # (heads, width, layers)
    if lm_cfg is not None and float(cfg["inference_conf"].get("lm_weight", 0.0)) > 0:
        d, h, _, count, _ = _lm_dims(lm_cfg)
        layers.append((h, d, count))
    total = 0.0
    for h, d, count in layers:
        dk = d // h
        cost = {"flops": 4.0 * n * h * live * dk,
                "bytes": float(2 * b * h * live * dk * e + 4 * n * h * dk * e + n * live * 4)}
        total += count * bound_s(cost, dtype)
    return total
