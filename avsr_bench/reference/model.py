"""Plain PyTorch reference of the benchmark's models, in float32: the
layers the families share. Each family's model is a module of its own
beside this one (``reference/<family>.py``, the configuration file's
``family``), built from these layers.

It imports neither JAX nor anything of the program under test. Its
modules carry the reference checkpoint's key grammar (the espnet names the
recipe's ``.pth`` files use), so one state dict made by the benchmark
loads into it and into the program alike. Seeded from a frozen copy of the
repository's independent twin of the flagship (``tests/torch_twins.py``):
made device-aware, with flax's LayerNorm epsilon (1e-6), its own
positional and mel tables and the relative-position term as an explicit
Toeplitz product; the audio-only model's Branchformer layer was added
(``branchformer_asr.py``).

Semantics (espnet, as the recipe configures it):
- audio: log-mel (n_fft 512, window 400, hop 160, 80 Slaney mels, log
  floor 1e-10), utterance mean subtraction over the valid frames, padding
  zeroed; conv2d subsampling by 4 (two VALID 3x3 stride-2 convs with ReLU,
  a linear layer over channels x frequencies);
- video: Conv3D stem (5x7x7, stride 1x2x2) + BatchNorm + swish + max-pool,
  a ResNet-18 trunk with swish, a global average pool; linear + LayerNorm;
- rel-pos MHA ("latest"): score(i, j) = (q_i + u) . k_j + (q_i + v) .
  p_{i-j}, over sqrt(dk), softmax over the valid keys;
- the CTC head; the Transformer decoder and the Transformer LM (pre-norm,
  ReLU feed-forward) for the beam's scores.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops

LN_EPS = 1e-6  # flax's LayerNorm epsilon, which the recipe's models use
BN_EPS = 1e-5


# -- tables ------------------------------------------------------------------


def sinusoid(positions: np.ndarray, d: int) -> np.ndarray:
    """sin on even columns, cos on odd ones, of position x 10000^(-2i/d)."""
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    ang = positions[:, None].astype(np.float64) * div[None]
    pe = np.zeros((len(positions), d), np.float64)
    pe[:, 0::2], pe[:, 1::2] = np.sin(ang), np.cos(ang)
    return pe.astype(np.float32)


def rel_pos_table(t: int, d: int, device) -> torch.Tensor:
    """(2t-1, d) relative table: row j encodes relative position t-1-j."""
    return torch.from_numpy(sinusoid(np.arange(t - 1, -t, -1), d)).to(device)


def slaney_mel(sr: int = 16000, n_fft: int = 512, n_mels: int = 80) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) Slaney mel filterbank, area-normalised
    (librosa's ``mel(htk=False, norm='slaney')``)."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2), n_mels + 2))
    lower = (freqs[None] - pts[:-2, None]) / np.diff(pts)[:-1, None]
    upper = (pts[2:, None] - freqs[None]) / np.diff(pts)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.T.astype(np.float32)


# -- small layers ------------------------------------------------------------


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, LN_EPS)


def batch_norm(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, BN_EPS)


class FFN(nn.Module):
    def __init__(self, d: int, units: int, d_out: Optional[int] = None, act: str = "swish"):
        super().__init__()
        self.w_1 = nn.Linear(d, units)
        self.w_2 = nn.Linear(units, d_out or d)
        self.act = F.silu if act == "swish" else F.relu

    def forward(self, x):
        return ops.linear(self.act(ops.linear(x, self.w_1)), self.w_2)


class MHA(nn.Module):
    """Scaled dot-product attention over ``mask``'s keys: (B, Tk) valid keys
    or (B, Tq, Tk)."""

    def __init__(self, d: int, h: int):
        super().__init__()
        self.h, self.dk = h, d // h
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            setattr(self, name, nn.Linear(d, d))

    def heads(self, x, lin):
        b, t, _ = x.shape
        return ops.linear(x, lin).view(b, t, self.h, self.dk).transpose(1, 2)

    def attend(self, scores, v, mask):
        m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)
        b, _, t, _ = attn.shape
        return ops.linear(ops.matmul(attn, v).transpose(1, 2).reshape(b, t, -1), self.linear_out)

    def forward(self, q_in, kv_in, mask):
        q, k, v = self.heads(q_in, self.linear_q), self.heads(kv_in, self.linear_k), self.heads(kv_in, self.linear_v)
        return self.attend(ops.matmul(q, k.transpose(-2, -1)) / math.sqrt(self.dk), v, mask)


class RelPosMHA(MHA):
    """espnet's ``RelPositionMultiHeadedAttention`` (latest): the position
    term read through the Toeplitz gather of the (2T-1)-row table, row
    T-1-i+j for query i and key j."""

    def __init__(self, d: int, h: int):
        super().__init__(d, h)
        self.linear_pos = nn.Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(h, d // h))
        self.pos_bias_v = nn.Parameter(torch.empty(h, d // h))

    def forward(self, x, pos, mask):
        b, t, _ = x.shape
        q = ops.linear(x, self.linear_q).view(b, t, self.h, self.dk)
        k, v = self.heads(x, self.linear_k), self.heads(x, self.linear_v)
        p = ops.linear(pos, self.linear_pos).view(-1, self.h, self.dk)  # (2T-1, H, dk)
        idx = (t - 1) - torch.arange(t, device=x.device)[:, None] + torch.arange(t, device=x.device)[None]
        ac = ops.matmul((q + self.pos_bias_u).transpose(1, 2), k.transpose(-2, -1))
        bd = ops.einsum("bhid,hijd->bhij", (q + self.pos_bias_v).transpose(1, 2), p[idx].permute(2, 0, 1, 3))
        return self.attend((ac + bd) / math.sqrt(self.dk), v, mask)


class CSGU(nn.Module):
    def __init__(self, units: int, kernel: int):
        super().__init__()
        half = units // 2
        self.norm = nn.LayerNorm(half)
        self.conv = nn.Conv1d(half, half, kernel, groups=half)

    def forward(self, h):
        x_r, x_g = h.chunk(2, dim=-1)
        k = self.conv.weight.shape[-1]
        x_g = ops.conv(layer_norm(x_g, self.norm).transpose(1, 2), self.conv, padding=(k - 1) // 2,
                       groups=x_g.shape[-1]).transpose(1, 2)
        return x_r * x_g


class CgMLP(nn.Module):
    def __init__(self, d: int, units: int, kernel: int):
        super().__init__()
        self.channel_proj1 = nn.Sequential(nn.Linear(d, units))
        self.csgu = CSGU(units, kernel)
        self.channel_proj2 = nn.Linear(units // 2, d)

    def forward(self, x):
        return ops.linear(self.csgu(F.gelu(ops.linear(x, self.channel_proj1[0]))), self.channel_proj2)


def pooled_weight(x, mask, pooling: nn.Linear, weight: nn.Linear) -> torch.Tensor:
    """Attention-pool ``x`` over its valid frames, one logit an utterance (B, 1)."""
    score = ops.linear(x, pooling).squeeze(-1) / math.sqrt(x.shape[-1])
    w = torch.softmax(score.masked_fill(~mask, torch.finfo(score.dtype).min), dim=-1).masked_fill(~mask, 0.0)
    return ops.linear(torch.einsum("bt,btd->bd", w, x), weight)


# -- input side --------------------------------------------------------------


def dequantize_audio(audio: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """int16 samples -> x / 32768, -1 past each length (the float path's pad)."""
    x = audio.float() / 32768.0
    return torch.where(torch.arange(x.shape[1], device=x.device)[None] < lengths[:, None], x, -1.0)


def dequantize_video(video: torch.Tensor, lengths: torch.Tensor, scale=250.0, mean=0.421, std=0.165):
    """uint8 crops -> (x / 250 - 0.421) / 0.165, -1 past each length."""
    x = (video.float() / scale - mean) / std
    valid = torch.arange(x.shape[1], device=x.device)[None] < lengths[:, None]
    return torch.where(valid[..., None, None], x, -1.0)


def logmel(x: torch.Tensor, lengths: torch.Tensor, n_fft=512, win=400, hop=160, n_mels=80):
    """(B, S) waveform -> (B, T', n_mels) log-mel, (B,) frame counts."""
    window = torch.hann_window(win, periodic=True, device=x.device)
    spec = torch.stft(x, n_fft=n_fft, hop_length=hop, win_length=win, window=window, center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    mel = ops.matmul(power, torch.from_numpy(slaney_mel(16000, n_fft, n_mels)).to(x.device))
    return torch.log(torch.clamp(mel, min=1e-10)), lengths // hop + 1


def utterance_mvn(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    mask = (torch.arange(x.shape[1], device=x.device)[None] < lengths[:, None]).float()[..., None]
    mean = (x * mask).sum(1, keepdim=True) / lengths.clamp(min=1).float()[:, None, None]
    return (x - mean) * mask


def sub4(n):
    """Frames after two VALID 3-wide stride-2 convolutions."""
    return ((n - 3) // 2 + 1 - 3) // 2 + 1


class Conv2dSubsampling(nn.Module):
    def __init__(self, d: int, feat: int = 80, out_seq: bool = False):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, d, 3, 2), nn.ReLU(), nn.Conv2d(d, d, 3, 2), nn.ReLU())
        f = ((feat - 3) // 2 + 1 - 3) // 2 + 1
        self.out = nn.Sequential(nn.Linear(d * f, d)) if out_seq else nn.Linear(d * f, d)

    def forward(self, x):
        h = F.relu(ops.conv(x[:, None], self.conv[0], stride=2))
        h = F.relu(ops.conv(h, self.conv[2], stride=2))
        b, c, t, f = h.shape
        out = self.out[0] if isinstance(self.out, nn.Sequential) else self.out
        return ops.linear(h.transpose(1, 2).reshape(b, t, c * f), out)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))

    def forward(self, x):
        res = x
        if self.downsample is not None:
            res = batch_norm(ops.conv(x, self.downsample[0], stride=self.stride), self.downsample[1])
        h = F.silu(batch_norm(ops.conv(x, self.conv1, stride=self.stride, padding=1), self.bn1))
        return F.silu(batch_norm(ops.conv(h, self.conv2, padding=1), self.bn2) + res)


class VisualFrontend(nn.Module):
    """Conv3D stem + per-frame ResNet-18 trunk: (B, T, H, W) -> (B, T, 512)."""

    def __init__(self):
        super().__init__()
        self.frontend3D = nn.Sequential(nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False),
                                        nn.BatchNorm3d(64))
        self.trunk = nn.Module()
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512), start=1):
            blocks = []
            for i in range(2):
                blocks.append(BasicBlock(inplanes, planes, 2 if stage > 1 and i == 0 else 1))
                inplanes = planes
            setattr(self.trunk, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, video):
        b, t = video.shape[:2]
        x = ops.conv(video[:, None], self.frontend3D[0], stride=(1, 2, 2), padding=(2, 3, 3))
        x = F.max_pool3d(F.silu(batch_norm(x, self.frontend3D[1])), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = x.transpose(1, 2).reshape(b * t, 64, x.shape[3], x.shape[4])
        for stage in (1, 2, 3, 4):
            for block in getattr(self.trunk, f"layer{stage}"):
                x = block(x)
        return x.mean(dim=(2, 3)).reshape(b, t, -1)


# -- heads, decoder and LM ----------------------------------------------------------


class CTCHead(nn.Module):
    def __init__(self, d, vocab):
        super().__init__()
        self.ctc_lo = nn.Linear(d, vocab)


class DecoderLayer(nn.Module):
    def __init__(self, d, h, units):
        super().__init__()
        self.self_attn, self.src_attn = MHA(d, h), MHA(d, h)
        self.feed_forward = FFN(d, units, act="relu")
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(d), nn.LayerNorm(d), nn.LayerNorm(d)

    def forward(self, x, tgt_mask, memory, memory_mask):
        h = layer_norm(x, self.norm1)
        x = x + self.self_attn(h, h, tgt_mask)
        x = x + self.src_attn(layer_norm(x, self.norm2), memory, memory_mask)
        return x + self.feed_forward(layer_norm(x, self.norm3))


class Decoder(nn.Module):
    """espnet's ``TransformerDecoder``: token embedding x sqrt(d) + the
    absolute table, pre-norm layers, ``after_norm``, ``output_layer``."""

    def __init__(self, vocab, d, h, units, blocks):
        super().__init__()
        self.embed = nn.Sequential(nn.Embedding(vocab, d))
        self.decoders = nn.ModuleList([DecoderLayer(d, h, units) for _ in range(blocks)])
        self.after_norm = nn.LayerNorm(d)
        self.output_layer = nn.Linear(d, vocab)

    def forward(self, ys, memory, memory_mask):
        """(N, L) tokens from <sos> -> (N, L, V) log-probs of each next token."""
        n, length = ys.shape
        d = self.embed[0].weight.shape[1]
        pe = torch.from_numpy(sinusoid(np.arange(length), d)).to(memory.device)
        x = self.embed[0].weight[ys] * math.sqrt(d) + pe
        causal = torch.tril(torch.ones(length, length, dtype=torch.bool, device=ys.device))[None].expand(n, -1, -1)
        for layer in self.decoders:
            x = layer(x, causal, memory, memory_mask)
        return torch.log_softmax(ops.linear(layer_norm(x, self.after_norm), self.output_layer), dim=-1)


class LMLayer(nn.Module):
    def __init__(self, d, h, units):
        super().__init__()
        self.self_attn = MHA(d, h)
        self.feed_forward = FFN(d, units, act="relu")
        self.norm1, self.norm2 = nn.LayerNorm(d), nn.LayerNorm(d)

    def forward(self, x, mask):
        h = layer_norm(x, self.norm1)
        x = x + self.self_attn(h, h, mask)
        return x + self.feed_forward(layer_norm(x, self.norm2))


class TransformerLM(nn.Module):
    """espnet2's ``TransformerLM`` with no positional encoding: Embedding ->
    Linear + LayerNorm + ReLU -> pre-norm layers -> ``after_norm`` ->
    Linear; keys under ``lm.``."""

    def __init__(self, vocab, embed_unit, d, h, units, layers):
        super().__init__()
        self.lm = nn.Module()
        self.lm.embed = nn.Embedding(vocab, embed_unit)
        self.lm.encoder = nn.Module()
        self.lm.encoder.embed = nn.Sequential(nn.Linear(embed_unit, d), nn.LayerNorm(d))
        self.lm.encoder.encoders = nn.ModuleList([LMLayer(d, h, units) for _ in range(layers)])
        self.lm.encoder.after_norm = nn.LayerNorm(d)
        self.lm.decoder = nn.Linear(d, vocab)

    def forward(self, ys):
        """(N, L) tokens from <sos> -> (N, L, V) log-probs of each next token."""
        enc = self.lm.encoder
        x = F.relu(layer_norm(ops.linear(self.lm.embed.weight[ys], enc.embed[0]), enc.embed[1]))
        length = ys.shape[1]
        mask = torch.tril(torch.ones(length, length, dtype=torch.bool, device=ys.device))[None].expand(len(ys), -1, -1)
        for layer in enc.encoders:
            x = layer(x, mask)
        return torch.log_softmax(ops.linear(layer_norm(x, enc.after_norm), self.lm.decoder), dim=-1)


# -- shared by the families (``reference/<family>.py``) -----------------------


def build_lm(cfg: Dict, vocab: int, device="meta") -> nn.Module:
    c = cfg["lm_conf"]
    with torch.device(device):
        return TransformerLM(vocab, c["embed_unit"], c["att_unit"], c["head"], c["unit"], c["layer"]).eval()


def ctc_log_probs(model: nn.Module, enc: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(ops.linear(enc, model.ctc.ctc_lo), dim=-1)


def encode_rows(model: nn.Module, batch: Dict[str, torch.Tensor], rows: Sequence[int]):
    """``model.encode`` of the utterances ``rows`` of a device batch."""
    idx = torch.as_tensor(list(rows), device=next(iter(batch.values())).device)
    return model.encode(*model.inputs({k: v[idx] for k, v in batch.items()}))


def _next_token_logp(logp: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum over each row's first ``lengths`` positions of the log-prob of its target."""
    picked = logp.gather(-1, targets[..., None])[..., 0].double()
    valid = torch.arange(targets.shape[1], device=targets.device)[None] < lengths[:, None]
    return (picked * valid).sum(-1)


@torch.no_grad()
def hypothesis_scores(model: nn.Module, lm: Optional[nn.Module], enc: torch.Tensor, enc_lens: torch.Tensor,
                      hyps: Sequence[Sequence[int]], ctc_weight: float, lm_weight: float) -> torch.Tensor:
    """The joint score the beam gives a finished hypothesis, recomputed in
    full: (1 - ctc_weight) x its decoder log-prob, eos included, +
    ctc_weight x log P_ctc(hypothesis) + lm_weight x its LM log-prob, eos
    included. ``enc`` (N, T, D) holds one row a hypothesis; float64 (N,)."""
    vocab = model.ctc.ctc_lo.weight.shape[0]
    sos = eos = vocab - 1
    n, dev = len(hyps), enc.device
    lens = torch.tensor([len(h) for h in hyps], device=dev)
    width = int(lens.max()) + 1
    ys_in = torch.full((n, width), eos, dtype=torch.long, device=dev)
    ys_out = torch.full((n, width), eos, dtype=torch.long, device=dev)
    ys_in[:, 0] = sos
    for i, h in enumerate(hyps):
        if len(h):
            ys_in[i, 1:len(h) + 1] = torch.tensor(h, device=dev)
            ys_out[i, :len(h)] = torch.tensor(h, device=dev)
    mem_mask = torch.arange(enc.shape[1], device=dev)[None] < enc_lens[:, None]
    att = _next_token_logp(model.decoder(ys_in, enc, mem_mask), ys_out, lens + 1)
    total = (1.0 - ctc_weight) * att
    if lm is not None and lm_weight > 0:
        total = total + lm_weight * _next_token_logp(lm(ys_in), ys_out, lens + 1)
    if ctc_weight > 0:
        lp = ctc_log_probs(model, enc).double().transpose(0, 1).cpu()  # (T, N, V)
        targets = torch.tensor([t for h in hyps for t in h], dtype=torch.long)
        nll = F.ctc_loss(lp, targets, enc_lens.cpu(), lens.cpu(), blank=0, reduction="none", zero_infinity=False)
        total = total + ctc_weight * -nll.to(dev)
    return total
