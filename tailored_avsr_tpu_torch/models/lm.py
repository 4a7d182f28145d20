"""Transformer language model for shallow fusion, and its ancestry-cache
beam step (counterpart of ``tailored_avsr_tpu/models/lm.py``).

Token embedding (``embed_unit``-d) -> input stack Linear(att_unit) +
LayerNorm + Dropout + ReLU (without ``embed_unit``: embed at ``att_unit``,
no stack) -> optional sinusoidal pos-enc -> N x (causal self-attention +
FFN, pre-norm) -> LayerNorm -> vocabulary projection.

Module names follow espnet's ``TransformerLM`` (the key grammar of the JAX
export, less its ``lm.`` prefix): ``embed``, ``encoder.embed.{0,1}``,
``encoder.encoders.{i}``, ``encoder.after_norm``, ``decoder``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tailored_avsr_tpu_torch import not_ported
from tailored_avsr_tpu_torch.models.decoder import anc_columns, cache_width, causal_mask, group_cache
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
        self.heads, self.d_k = head, att_unit // head
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

    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids -> att_unit features (embedding + input stack, no pos-enc)."""
        x = self.embed(tokens)
        return self.encoder.embed(x) if self.encoder.embed is not None else x

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, T, V) next-token logits."""
        b, t = tokens.shape
        mask = causal_mask(b, t, lengths, device=tokens.device)
        x = self._embed_in(tokens)
        if self.posenc is not None:
            x = self.posenc(x)
        for layer in self.encoder.encoders:
            x = layer(x, mask)
        return self.decoder(self.encoder.after_norm(x))

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
        n, l = ys.shape
        lc = cache_width(cache)
        p = min(max(pos - 1, 0), l - 1)
        x = self._embed_in(ys[:, p:p + 1])
        if self.posenc is not None:
            x = self.posenc.at_position(x, pos - 1, lc)
        anc = anc_columns(anc, lc)
        new_kv = []
        for layer, (ck, cv) in zip(self.encoder.encoders, cache):
            h = layer.norm1(x)
            q, k_new, v_new = layer.self_attn.project_qkv(h)
            x = x + layer.self_attn.attend_kv_anc(ck, cv, k_new, v_new, anc, pos, beam, q,
                                                  width=width, fused=fused)
            h = layer.norm2(x)
            x = x + layer.feed_forward(h)
            new_kv.append((k_new, v_new))
        logits = self.decoder(self.encoder.after_norm(x))
        return torch.log_softmax(logits[:, 0].float(), dim=-1), new_kv

    def score_step(self, *args, **kwargs):
        raise not_ported("TransformerLM.score_step (full-prefix recompute)", 7)

    def score_step_cached(self, *args, **kwargs):
        raise not_ported("TransformerLM.score_step_cached", 7)

    def score_step_append(self, *args, **kwargs):
        raise not_ported("TransformerLM.score_step_append (cache_protocol: append)", 7)
