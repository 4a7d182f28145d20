"""Transformer language model for shallow fusion, and its ancestry-cache
beam step (counterpart of ``tailored_avsr_tpu/models/lm.py``).

Token embedding (``embed_unit``-d) -> input stack Linear(att_unit) +
LayerNorm + Dropout + ReLU (without ``embed_unit``: embed at ``att_unit``,
no stack) -> optional sinusoidal pos-enc -> N x (causal self-attention +
FFN, pre-norm) -> LayerNorm -> vocabulary projection.

Module names follow espnet's ``TransformerLM`` (the key grammar of the JAX
export, less its ``lm.`` prefix): ``embed``, ``encoder.embed.{0,1}``,
``encoder.encoders.{i}``, ``encoder.after_norm``, ``decoder``.

Beam steps of every cache protocol of the JAX engine, as the decoder's
(``models/decoder.py``): ``score_step_anc`` over the group cache,
``score_step_append`` and ``score_step_cached`` over an (N, H, Lc, dk)
cache, and the full-prefix ``score_step`` that scores an LM left out of
the decoder's scorer (``ctc_weight: 1.0``); ``nll`` the per-sequence
negative log-likelihood for rescoring.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tailored_avsr_tpu_torch.models.decoder import (
    anc_columns,
    cache_width,
    causal_mask,
    by_dtype,
    group_cache,
    plain_cache,
)
from tailored_avsr_tpu_torch.ops.attention import MultiHeadedAttention
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.ops.posenc import AbsolutePositionalEncoding

_LN_EPS = 1e-6  # flax LayerNorm default


class TransformerLMLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int = 8, linear_units: int = 2048,
                 dropout_rate: float = 0.1, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attn = MultiHeadedAttention(attention_heads, dropout_rate, size, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, "relu", **kw)
        self.norm1 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, mask):
        h = self.norm1(x)
        x = x + self.dropout(self.self_attn(h, h, h, mask))
        h = self.norm2(x)
        return x + self.dropout(self.feed_forward(h))


class _LMEncoder(nn.Module):
    """The input stack (``embed``, absent without ``embed_unit``), the layers
    (``encoders``) and ``after_norm``."""

    def __init__(self, embed: Optional[nn.Module], layers, after_norm: nn.Module):
        super().__init__()
        self.embed = embed
        self.encoders = nn.ModuleList(layers)
        self.after_norm = after_norm


class TransformerLM(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        att_unit: int = 512,
        head: int = 8,
        unit: int = 2048,
        layer: int = 16,
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.1,
        embed_unit: Optional[int] = None,
        pos_enc: Optional[str] = "sinusoidal",
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        if pos_enc not in (None, "sinusoidal"):
            raise NotImplementedError(
                f"lm_conf pos_enc={pos_enc!r}: espnet TransformerLM supports only null or 'sinusoidal'")
        kw = {"device": device, "dtype": dtype}
        self.att_unit, self.heads, self.d_k = att_unit, head, att_unit // head
        self.embed = nn.Embedding(vocab_size, embed_unit or att_unit, **kw)
        stack = None
        if embed_unit:
            stack = nn.Sequential(nn.Linear(embed_unit, att_unit, **kw),
                                  nn.LayerNorm(att_unit, eps=_LN_EPS, **kw),
                                  nn.Dropout(dropout_rate), nn.ReLU())
        self.encoder = _LMEncoder(
            stack,
            (TransformerLMLayer(att_unit, head, unit, dropout_rate, **kw) for _ in range(layer)),
            nn.LayerNorm(att_unit, eps=_LN_EPS, **kw),
        )
        self.posenc = AbsolutePositionalEncoding(positional_dropout_rate) if pos_enc else None
        self.decoder = nn.Linear(att_unit, vocab_size, **kw)

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' floating dtype (LayerNorm weights are never quantised)."""
        return self.encoder.after_norm.weight.dtype

    def _embed_in(self, tokens: torch.Tensor, pos: Optional[int] = None, lc: int = 0) -> torch.Tensor:
        """Token ids -> att_unit features with the pos-enc (at position
        ``pos`` of a table of ``lc`` rows for a one-token step), in the
        model's dtype (a bf16 embedding table under an f32 model:
        ``AbsolutePositionalEncoding``)."""
        x = self.embed(tokens)
        if self.encoder.embed is not None:
            x = self.encoder.embed(x.to(self.dtype))
        if self.posenc is not None:
            x = self.posenc(x, self.dtype) if pos is None else self.posenc.at_position(x, pos, lc, self.dtype)
        return x.to(self.dtype)

    def _run(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self._embed_in(tokens)
        for layer in self.encoder.encoders:
            x = layer(x, mask)
        return self.decoder(self.encoder.after_norm(x))

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, T, V) next-token logits."""
        b, t = tokens.shape
        return self._run(tokens, causal_mask(b, t, lengths, device=tokens.device))

    def score_step(self, ys: torch.Tensor, pos: int) -> torch.Tensor:
        """f32 log-probs (N, V) of the token at ``pos`` given ``ys[:, :pos]``:
        the whole (N, L) buffer recomputed, the first ``pos`` tokens visible."""
        b, t = ys.shape
        mask = causal_mask(b, t, device=ys.device) & (torch.arange(t, device=ys.device) < pos)[None, None, :]
        return torch.log_softmax(self._run(ys, mask)[:, pos - 1].float(), dim=-1)

    def _step_input(self, ys: torch.Tensor, pos: int, lc: int) -> torch.Tensor:
        p = min(max(pos - 1, 0), ys.shape[1] - 1)
        return self._embed_in(ys[:, p:p + 1], pos - 1, lc)

    def init_cache(self, n: int, max_len: int, dtype=torch.float32, *, device=None):
        """Per-layer zero (K, V) caches (N, H, max_len, dk) for
        ``score_step_cached`` / ``score_step_append``."""
        device = device if device is not None else self.decoder.weight.device
        return plain_cache(len(self.encoder.encoders), n, max_len, self.heads, self.d_k, dtype, device)

    def score_step_cached(self, ys: torch.Tensor, pos: int, cache):
        """Beam step over (N, H, Lc, dk) caches that it writes itself at
        column ``pos - 1`` (in place) -> ((N, V) f32 log-probs, the caches)."""
        lc = cache[0][0].shape[2]
        x = self._step_input(ys, pos, lc)
        self_mask = (torch.arange(lc, device=ys.device) < pos)[None].expand(ys.shape[0], lc)
        at = by_dtype(self)
        for i, (ck, cv) in enumerate(cache):
            layer = at(x.dtype).encoder.encoders[i]
            h = layer.norm1(x)
            k_new, v_new = layer.self_attn.project_kv(h)
            ck[:, :, pos - 1] = k_new[:, :, 0].to(ck.dtype)
            cv[:, :, pos - 1] = v_new[:, :, 0].to(cv.dtype)
            x = x + layer.self_attn.attend_kv(h, ck, cv, self_mask)
            layer = at(x.dtype).encoder.encoders[i]  # f32 past a wider cache
            x = x + layer.feed_forward(layer.norm2(x))
        head = at(x.dtype)
        logits = head.decoder(head.encoder.after_norm(x))
        return torch.log_softmax(logits[:, 0].float(), dim=-1), cache

    def score_step_append(self, ys: torch.Tensor, pos: int, cache):
        """Cache-read-only beam step (the append protocol) -> ((N, V) f32
        log-probs, per-layer (k_new, v_new) (N, H, 1, dk) columns)."""
        lc = cache[0][0].shape[2]
        x = self._step_input(ys, pos, lc)
        cache_mask = (torch.arange(lc, device=ys.device) < pos - 1)[None].expand(ys.shape[0], lc)
        at, new_kv = by_dtype(self), []
        for i, (ck, cv) in enumerate(cache):
            layer = at(x.dtype).encoder.encoders[i]
            h = layer.norm1(x)
            q, k_new, v_new = layer.self_attn.project_qkv(h)
            x = x + layer.self_attn.attend_kv_append(h, ck, cv, k_new, v_new, cache_mask, q_heads=q)
            layer = at(x.dtype).encoder.encoders[i]  # f32 past a wider cache
            x = x + layer.feed_forward(layer.norm2(x))
            new_kv.append((k_new, v_new))
        head = at(x.dtype)
        logits = head.decoder(head.encoder.after_norm(x))
        return torch.log_softmax(logits[:, 0].float(), dim=-1), new_kv

    def nll(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """Per-sequence (negative log-likelihood, token count) of (B, L)
        sos/eos-free token rows padded with negatives past ``lengths``,
        wrapped in sos / eos (both ``V - 1``) as espnet's LM does."""
        eos = self.decoder.out_features - 1
        b, l = tokens.shape
        real = tokens >= 0
        ys_in = torch.cat([torch.full((b, 1), eos, dtype=tokens.dtype, device=tokens.device),
                           torch.where(real, tokens, eos)], dim=-1)
        pos = torch.arange(l + 1, device=tokens.device)[None, :]
        ys_out = torch.cat([torch.where(real, tokens, 0), torch.zeros_like(tokens[:, :1])], dim=-1)
        ys_out = torch.where(pos == lengths[:, None], eos, ys_out)
        valid = pos <= lengths[:, None]
        logp = torch.log_softmax(self(ys_in, lengths + 1).float(), dim=-1)
        tok_ll = torch.gather(logp, -1, ys_out[..., None].long())[..., 0]
        return -(tok_ll * valid).sum(dim=-1), valid.sum(dim=-1)

    def init_cache_group(self, b: int, beam: int, max_len: int, dtype=torch.float32, *, device=None,
                         quantized: bool = False):
        """Group-major (B, H, beam, Lc, dk) per-layer (K, V) zero caches for
        ``score_step_anc``; Lc is ``max_len`` rounded up to a multiple of 8.
        ``quantized``: int8 payload + per-column scale sides (``group_cache``)."""
        device = device if device is not None else self.decoder.weight.device
        return group_cache(len(self.encoder.encoders), b, beam, max_len, self.heads, self.d_k,
                           dtype, device, quantized)

    def score_step_anc(self, ys: torch.Tensor, pos: int, cache, anc: torch.Tensor, beam: int,
                       width: Optional[int] = None, fused: Optional[bool] = None):
        """Ancestry-cache beam step -> ((N, V) f32 log-probs of the token at
        ``pos``, per-layer (k_new, v_new) (N, H, 1, dk) columns to write)."""
        lc = cache_width(cache)
        x = self._step_input(ys, pos, lc)
        anc = anc_columns(anc, lc)
        at, new_kv = by_dtype(self), []
        for i, (ck, cv) in enumerate(cache):
            layer = at(x.dtype).encoder.encoders[i]
            h = layer.norm1(x)
            q, k_new, v_new = layer.self_attn.project_qkv(h)
            x = x + layer.self_attn.attend_kv_anc(ck, cv, k_new, v_new, anc, pos, beam, q,
                                                  width=width, fused=fused)
            layer = at(x.dtype).encoder.encoders[i]  # f32 past a wider cache
            x = x + layer.feed_forward(layer.norm2(x))
            new_kv.append((k_new, v_new))
        head = at(x.dtype)
        logits = head.decoder(head.encoder.after_norm(x))
        return torch.log_softmax(logits[:, 0].float(), dim=-1), new_kv
