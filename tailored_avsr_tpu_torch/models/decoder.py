"""Autoregressive Transformer decoder and its ancestry-cache beam step
(counterpart of ``TransformerDecoder`` in ``tailored_avsr_tpu/models/decoder.py``).

Token embedding + absolute pos-enc -> N x (causal self-attention,
cross-attention over the encoder memory, FFN), pre-norm, final LayerNorm and
the vocabulary projection. Ported: the full forward, ``precompute_memory``,
``init_cache_group`` (exact cache) and ``score_step_anc``, the step the
label-synchronous beam runs. The other beam-step protocols raise, naming
their ``ROADMAP.md`` item; the other layer variants are refused by
``tasks/common.build_decoder_and_ctc``.

``MLMDecoder`` (Mask-CTC, ``decoder.py:682``) is the same stack with full
self-attention among each sequence's valid tokens: a (B, L) key-side
validity mask in place of the causal one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tailored_avsr_tpu_torch import not_ported
from tailored_avsr_tpu_torch.ops.attention import MultiHeadedAttention
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.ops.posenc import AbsolutePositionalEncoding

_LN_EPS = 1e-6  # flax LayerNorm default


def causal_mask(b: int, t: int, lengths: Optional[torch.Tensor] = None, *, device=None) -> torch.Tensor:
    """(B, T, T) True where key j <= query i (and j < length if given)."""
    m = torch.tril(torch.ones(t, t, dtype=torch.bool, device=device))[None].expand(b, t, t)
    if lengths is not None:
        m = m & (torch.arange(t, device=device)[None, None, :] < lengths[:, None, None])
    return m


def group_cache(layers: int, b: int, beam: int, max_len: int, heads: int, dk: int,
                dtype, device, quantized: bool = False) -> list:
    """Per-layer zero (K, V) caches (B, H, beam, Lc, dk), Lc = max_len
    rounded up to a multiple of 8 (the JAX package's float shapes). With
    ``quantized`` each side is an (int8 payload (B, H, beam, Lc, dk), f32
    scale (B, H, beam, Lc)) tuple (``ops/kv_quant.py``); the JAX package
    rounds that Lc to 32 for Mosaic's int8 tile, which no value depends on."""
    lc = -(-max_len // 8) * 8
    shape = (b, heads, beam, lc, dk)
    if quantized:
        def side():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:4], dtype=torch.float32, device=device))
    else:
        def side():
            return torch.zeros(shape, dtype=dtype, device=device)
    return [(side(), side()) for _ in range(layers)]


def cache_width(cache) -> int:
    """Lc of per-layer (K, V) group caches, float or (payload, scale) sides."""
    k0 = cache[0][0]
    return (k0[0] if isinstance(k0, tuple) else k0).shape[3]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int = 4, linear_units: int = 2048,
                 self_attention_dropout_rate: float = 0.0, src_attention_dropout_rate: float = 0.0,
                 dropout_rate: float = 0.1, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attn = MultiHeadedAttention(attention_heads, self_attention_dropout_rate, size, **kw)
        self.src_attn = MultiHeadedAttention(attention_heads, src_attention_dropout_rate, size, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, "relu", **kw)
        self.norm1 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm3 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        h = self.norm1(tgt)
        tgt = tgt + self.dropout(self.self_attn(h, h, h, tgt_mask))
        h = self.norm2(tgt)
        tgt = tgt + self.dropout(self.src_attn(h, memory, memory, memory_mask))
        h = self.norm3(tgt)
        return tgt + self.dropout(self.feed_forward(h))


class TransformerDecoder(nn.Module):
    """``embed`` (token embedding, pos-enc), ``decoders``, ``after_norm``,
    ``output_layer``: the reference key grammar."""

    def __init__(
        self,
        vocab_size: int,
        encoder_output_size: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 6,
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.1,
        self_attention_dropout_rate: float = 0.0,
        src_attention_dropout_rate: float = 0.0,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = encoder_output_size
        self.heads, self.d_k = attention_heads, d // attention_heads
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d, **kw),
                                   AbsolutePositionalEncoding(positional_dropout_rate))
        self.decoders = nn.ModuleList(
            TransformerDecoderLayer(d, attention_heads, linear_units, self_attention_dropout_rate,
                                    src_attention_dropout_rate, dropout_rate, **kw)
            for _ in range(num_blocks)
        )
        self.after_norm = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.output_layer = nn.Linear(d, vocab_size, **kw)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_layer(self.after_norm(x))

    def forward(self, memory, memory_mask, ys_in, ys_in_lengths) -> torch.Tensor:
        """(B, T) tokens -> (B, T, V) logits, causal over each length."""
        b, t = ys_in.shape
        tgt_mask = causal_mask(b, t, ys_in_lengths, device=ys_in.device)
        x = self.embed(ys_in)
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask)
        return self._head(x)

    def precompute_memory(self, memory: torch.Tensor):
        """Per-layer cross-attention (K, V), each (B, H, T, dk)."""
        return [layer.src_attn.project_kv(memory) for layer in self.decoders]

    def init_cache_group(self, b: int, beam: int, max_len: int, dtype=torch.float32, *, device=None,
                         quantized: bool = False):
        """Group-major (B, H, beam, Lc, dk) per-layer (K, V) zero caches for
        ``score_step_anc``; Lc is ``max_len`` rounded up to a multiple of 8.
        ``quantized``: int8 payload + per-column scale sides (``group_cache``)."""
        device = device if device is not None else self.after_norm.weight.device
        return group_cache(len(self.decoders), b, beam, max_len, self.heads, self.d_k, dtype, device,
                           quantized)

    def score_step_anc(
        self,
        mem_kv,  # per-layer (K, V) from precompute_memory, B rows (int8: (payload, scale) sides)
        memory_mask: Optional[torch.Tensor],  # (B, T), not beam-repeated
        ys: torch.Tensor,  # (N, L) token buffer, N = B*beam
        pos: int,  # position being generated
        cache,  # per-layer (K, V) group caches (float or (payload, scale) sides), never reordered
        anc: torch.Tensor,  # (N, >=Lc) int32 ancestry table
        beam: int,
        width: Optional[int] = None,  # attend cache columns [0, width)
        fused: Optional[bool] = None,  # group-attend choice (attend_kv_anc)
    ):
        """Ancestry-cache beam step -> ((N, V) f32 log-probs of the token at
        ``pos``, per-layer (k_new, v_new) (N, H, 1, dk) columns to write)."""
        n, l = ys.shape
        lc = cache_width(cache)
        p = min(max(pos - 1, 0), l - 1)
        x = self.embed[0](ys[:, p:p + 1])  # (N, 1, D)
        x = self.embed[1].at_position(x, pos - 1, lc)
        anc = anc_columns(anc, lc)
        new_kv = []
        for layer, (mk, mv), (ck, cv) in zip(self.decoders, mem_kv, cache):
            h = layer.norm1(x)
            q, k_new, v_new = layer.self_attn.project_qkv(h)  # (N, H, 1, dk)
            x = x + layer.self_attn.attend_kv_anc(ck, cv, k_new, v_new, anc, pos, beam, q,
                                                  width=width, fused=fused)
            h = layer.norm2(x)
            x = x + layer.src_attn.attend_kv_mem_grouped(h, mk, mv, memory_mask, beam)
            h = layer.norm3(x)
            x = x + layer.feed_forward(h)
            new_kv.append((k_new, v_new))
        return torch.log_softmax(self._head(x)[:, 0].float(), dim=-1), new_kv

    def score_step(self, *args, **kwargs):
        raise not_ported("TransformerDecoder.score_step (full-prefix recompute)", 7)

    def score_step_cached(self, *args, **kwargs):
        raise not_ported("TransformerDecoder.score_step_cached", 7)

    def score_step_append(self, *args, **kwargs):
        raise not_ported("TransformerDecoder.score_step_append (cache_protocol: append)", 7)

    def score_step_cached_seg(self, *args, **kwargs):
        raise not_ported("TransformerDecoder.score_step_cached_seg (cache_segments > 1)", 7)


class MLMDecoder(TransformerDecoder):
    """Mask-CTC's conditional masked LM: non-causal self-attention over the
    valid tokens (its vocabulary holds ``<mask>`` as its last entry)."""

    def forward(self, memory, memory_mask, ys_in, ys_in_lengths) -> torch.Tensor:
        """(B, L) tokens -> (B, L, V) logits, every valid token seeing every
        valid token."""
        tgt_mask = torch.arange(ys_in.shape[1], device=ys_in.device)[None, :] < ys_in_lengths[:, None]
        x = self.embed(ys_in)
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask)
        return self._head(x)


def anc_columns(anc: torch.Tensor, lc: int) -> torch.Tensor:
    """The first ``lc`` columns of the (N, >=Lc) ancestry table, contiguous,
    taken once per step for all layers of one model."""
    return anc if anc.shape[1] == lc else anc[:, :lc].contiguous()
