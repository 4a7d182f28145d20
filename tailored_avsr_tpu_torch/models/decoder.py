"""Attention decoders and the Transformer's cache beam steps (counterpart
of ``tailored_avsr_tpu/models/decoder.py``).

Token embedding + absolute pos-enc -> N x layer -> final LayerNorm and the
vocabulary projection (none with ``use_output_layer: false``). The layer is
chosen by ``layer_variant``, as in the JAX ``_DecoderBase``:

- ``transformer``: causal self-attention, cross-attention over the encoder
  memory, FFN (pre-norm);
- ``sim_t`` (``SimTDecoderLayer``): one MHA and one FFN, each used twice;
  the first layer's self-attention probabilities are re-applied to fresh
  values in every layer (``apply_scores``, no output projection);
- ``lightconv`` / ``dynamicconv`` and their ``2d`` forms
  (``ConvDecoderLayer``): a causal convolution after a GLU in place of the
  self-attention, its softmax-normalised kernels shared across
  ``conv_wshare`` channel groups (channel c in group c // (D / wshare)),
  learned or predicted per position, over time or over the (time,
  feature) plane; ``conv_kernel_length`` an int or one value a layer.

The full forward and the full-prefix recompute ``score_step`` serve every
variant; ``score_step`` runs only the prefix ``ys[:, :pos]`` of a variant
other than ``transformer`` (every layer is causal, so the step's log-probs
are the whole buffer's). The cache beam steps are the Transformer's, as
the JAX package asserts: ``precompute_memory`` and ``score_step_anc`` over
the never-reordered group cache (``init_cache_group``), the append
protocol's ``score_step_append`` over a physically reordered (N, H, Lc,
dk) cache (``init_cache``), whose in-scorer-write twin is
``score_step_cached``, and the length-segmented cache (``init_cache_seg``,
``score_step_cached_seg``, ``gather_cache_seg``).

A group cache wider than the model (``cache_dtype: float32`` under a bf16
model) makes the first self-attention's output f32, and, as flax promotes
its inputs and kernels, the rest of the step then runs in f32 on the bf16
weights: here through an f32 copy of the model made once
(``widened``).

``MLMDecoder`` (Mask-CTC, ``decoder.py:682``) is the same stack with full
self-attention among each sequence's valid tokens: a (B, L) key-side
validity mask in place of the causal one. The classes ``SimTDecoder``,
``SimTMLMDecoder``, ``LightConvDecoder``, ``DynamicConvDecoder``,
``LightConv2DDecoder`` and ``DynamicConv2DDecoder`` only change the
default ``layer_variant`` (``decoder.py:701-739``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.models import remat
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


def _dequantized(module: nn.Module) -> nn.Module:
    """``module`` with every quantised weight (``utils/quantize.py``) made a
    plain parameter, dequantised as the JAX package dequantises it (an int8
    payload x scale rounded to the scale's dtype, a bf16 payload as it
    is), in place. Its modules are copies: their parametrized class, which
    ``copy.deepcopy`` shares with the originals, is not touched."""
    for m in module.modules():
        plist = m._modules.pop("parametrizations", None)
        if plist is not None:
            m.__class__ = type(m).__bases__[0]  # the class before parametrization
            for name, weights in plist.items():
                m.register_parameter(name, nn.Parameter(weights(), requires_grad=False))
    return module


def widened(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An eval-mode copy of ``module`` with its floating parameters in
    ``dtype`` (the bf16 weights upcast exactly), kept beside it and made
    again only when a parameter was replaced or written. A quantised weight
    enters the copy dequantised (``_dequantized``), then widened, as flax
    promotes the weight the JAX package dequantises; the key reads the
    payloads and scales, which are the parameters."""
    key = tuple((p.data_ptr(), p._version) for p in module.parameters())
    twins = module.__dict__.pop("_widened", {})  # not copied into the twin
    try:
        if twins.get(dtype, (None,))[0] != key:
            with torch.inference_mode(False), torch.no_grad():  # plain tensors: kept across calls
                twins[dtype] = (key, _dequantized(copy.deepcopy(module)).to(dtype).eval())
    finally:
        module.__dict__["_widened"] = twins
    return twins[dtype][1]


def by_dtype(module: nn.Module):
    """dtype -> ``module`` for inputs of its own dtype, else its ``widened``
    copy (looked up once a call)."""
    found = {module.dtype: module}

    def get(dtype: torch.dtype) -> nn.Module:
        if dtype not in found:
            found[dtype] = widened(module, dtype)
        return found[dtype]
    return get


def wider_than(module: nn.Module, memory: torch.Tensor):
    """``by_dtype(module)`` when ``memory`` is wider than the module's
    weights (an RNN encoder's f32 output under a bf16 model), else None: a
    flax module then runs every product after the first one that reads the
    memory in f32, on the bf16 weights upcast."""
    if torch.promote_types(memory.dtype, module.dtype) == module.dtype:
        return None
    return by_dtype(module)


def layer_at(at, stack: str, i: int):
    """dtype -> layer ``i`` of ``stack`` in the model ``at`` gives for it."""
    return lambda dtype: getattr(at(dtype), stack)[i]


def _at(layer: nn.Module, at, x: torch.Tensor) -> nn.Module:
    """``layer``, or (``at`` given) its copy in x's dtype."""
    return layer if at is None else at(x.dtype)


def plain_cache(layers: int, n: int, max_len: int, heads: int, dk: int, dtype, device) -> list:
    """Per-layer zero (K, V) caches (N, H, max_len, dk), rows N leading."""
    return [tuple(torch.zeros((n, heads, max_len, dk), dtype=dtype, device=device) for _ in range(2))
            for _ in range(layers)]


def cache_width(cache) -> int:
    """Lc of per-layer (K, V) group caches, float or (payload, scale) sides."""
    k0 = cache[0][0]
    return (k0[0] if isinstance(k0, tuple) else k0).shape[3]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int = 4, linear_units: int = 2048,
                 self_attention_dropout_rate: float = 0.0, src_attention_dropout_rate: float = 0.0,
                 dropout_rate: float = 0.1, memory_size: Optional[int] = None, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.self_attn = MultiHeadedAttention(attention_heads, self_attention_dropout_rate, size, **kw)
        self.src_attn = MultiHeadedAttention(attention_heads, src_attention_dropout_rate, size, memory_size, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, "relu", **kw)
        self.norm1 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm3 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask, at=None):
        m = _at(self, at, tgt)
        h = m.norm1(tgt)
        tgt = tgt + m.dropout(m.self_attn(h, h, h, tgt_mask))
        m = _at(self, at, tgt)
        h = m.norm2(tgt)
        tgt = tgt + m.dropout(m.src_attn(h, memory, memory, memory_mask))
        m = _at(self, at, tgt)  # f32 past a wider memory
        return tgt + m.dropout(m.feed_forward(m.norm3(tgt)))


class SimTDecoderLayer(nn.Module):
    """Sim-T (``decoder.py:88``): ``mha_attn`` serves the self-attention,
    the cross-attention and the post-attention, ``feed_forward`` both FFN
    sub-blocks; ``norm_mha`` / ``norm_ffn`` before each use."""

    def __init__(self, size: int, attention_heads: int = 4, linear_units: int = 2048,
                 attention_dropout_rate: float = 0.0, dropout_rate: float = 0.1, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.mha_attn = MultiHeadedAttention(attention_heads, attention_dropout_rate, size, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, "relu", **kw)
        self.norm_mha = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm_ffn = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask, s1=None, at=None):
        """-> (output, ``s1``): the first layer (``s1`` None) donates its
        self-attention probabilities (B, H, T, T) to the layers after it."""
        m = _at(self, at, tgt)
        h = m.norm_mha(tgt)
        out, scores = m.mha_attn.attend(h, h, h, tgt_mask)
        x = tgt + m.dropout(out)
        if s1 is None:
            s1 = scores
        m = _at(self, at, x)
        h = m.norm_mha(x)
        x = x + m.dropout(m.mha_attn(h, memory, memory, memory_mask))
        m = _at(self, at, x)  # f32 past a wider memory
        x = x + m.dropout(m.feed_forward(m.norm_ffn(x)))
        x = x + m.mha_attn.apply_scores(m.norm_mha(x), s1)
        return x + m.dropout(m.feed_forward(m.norm_ffn(x))), s1


class ConvDecoderLayer(nn.Module):
    """Lightweight / dynamic convolution decoder layer (``decoder.py:140``):
    ``glu_proj`` (GLU), the causal convolution (``conv_weight`` (wshare,
    taps), or ``weight_proj`` predicting it per position; ``conv_bias``
    with ``use_bias``), ``out_proj``, then cross-attention and the FFN. The
    2D form convolves over (time, feature): causal in time, ``same`` with
    zero padding in feature, the flattened tap index time tap x k +
    feature tap."""

    def __init__(self, size: int, attention_heads: int = 4, linear_units: int = 2048, kernel_size: int = 11,
                 dynamic: bool = False, two_dim: bool = False, wshare: int = 4, use_bias: bool = False,
                 src_attention_dropout_rate: float = 0.0, dropout_rate: float = 0.1, memory_size: Optional[int] = None,
                 *, device=None, dtype=None):
        super().__init__()
        if size % wshare:
            raise ValueError(f"conv_wshare {wshare} does not divide the decoder width {size}")
        kw = {"device": device, "dtype": dtype}
        self.kernel_size, self.dynamic, self.two_dim, self.wshare = kernel_size, dynamic, two_dim, wshare
        taps = kernel_size * kernel_size if two_dim else kernel_size
        self.glu_proj = nn.Linear(size, 2 * size, **kw)
        if dynamic:
            self.weight_proj = nn.Linear(size, wshare * taps, **kw)
        else:
            self.conv_weight = nn.Parameter(torch.empty(wshare, taps, **kw))
        self.conv_bias = nn.Parameter(torch.empty(size, **kw)) if use_bias else None
        self.out_proj = nn.Linear(size, size, **kw)
        self.src_attn = MultiHeadedAttention(attention_heads, src_attention_dropout_rate, size, memory_size, **kw)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate, "relu", **kw)
        self.norm1 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.norm3 = nn.LayerNorm(size, eps=_LN_EPS, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def _conv(self, h: torch.Tensor) -> torch.Tensor:
        """The convolution sub-block: the sums of the JAX einsums per channel
        group, the group's kernel never repeated over its channels."""
        b, t, d = h.shape
        g, k = self.wshare, self.kernel_size
        x = self.glu_proj(h)
        x = x[..., :d] * torch.sigmoid(x[..., d:])
        if self.dynamic:
            w = torch.softmax(self.weight_proj(x).reshape(b, t, g, -1), dim=-1)  # (B, T, G, taps)
        else:
            w = torch.softmax(self.conv_weight, dim=-1)  # (G, taps)
        xp = F.pad(x, (0, 0, k - 1, 0))  # causal: k - 1 steps of zeros before the first
        if not self.two_dim:
            if not self.dynamic:  # depthwise: channel c takes its group's kernel
                wd = w.repeat_interleave(d // g, dim=0)[:, None, :]
                y = F.conv1d(xp.transpose(1, 2), wd, groups=d).transpose(1, 2)
            else:  # (B, T, G, D/G, k) taps against (B, T, G, k)
                taps = xp.unfold(1, k, 1).reshape(b, t, g, d // g, k)
                y = (taps @ w[..., None]).squeeze(-1).reshape(b, t, d)
        else:
            pf = k // 2
            tt = F.pad(xp, (pf, pf)).unfold(1, k, 1)  # (B, T, D + 2 pf, k time taps)
            w = w.reshape(w.shape[:-1] + (k, k))  # (..., time tap, feature tap)
            y = torch.zeros((b, t, d), dtype=x.dtype, device=x.device)
            for j in range(k):  # feature tap j of channel c reads channel c - pf + j
                tj = tt[:, :, j:j + d].reshape(b, t, g, d // g, k)
                wj = w[..., j]  # (B, T, G, k) or (G, k)
                y = y + (tj @ (wj[..., None] if self.dynamic else wj[:, :, None])).squeeze(-1).reshape(b, t, d)
        if self.conv_bias is not None:
            y = y + self.conv_bias
        return self.out_proj(y)

    def forward(self, tgt, tgt_mask, memory, memory_mask, at=None):
        # the taps look only left, so ``tgt_mask`` (a causal or padding mask)
        # changes nothing: padded positions are always to the right
        m = _at(self, at, tgt)
        tgt = tgt + m.dropout(m._conv(m.norm1(tgt)))
        h = m.norm2(tgt)
        tgt = tgt + m.dropout(m.src_attn(h, memory, memory, memory_mask))
        m = _at(self, at, tgt)  # f32 past a wider memory
        return tgt + m.dropout(m.feed_forward(m.norm3(tgt)))


CONV_VARIANTS = ("lightconv", "dynamicconv", "lightconv2d", "dynamicconv2d")


class TransformerDecoder(nn.Module):
    """``embed`` (token embedding, pos-enc), ``decoders``, ``after_norm``,
    ``output_layer``: the reference key grammar. ``layer_variant`` (None:
    the class's) picks the layers, as the JAX ``_DecoderBase`` does."""

    layer_variant = "transformer"

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
        use_output_layer: bool = True,
        layer_variant: Optional[str] = None,
        conv_kernel_length=11,
        conv_wshare: int = 4,
        conv_usebias: bool = False,
        memory_size: Optional[int] = None,  # the memory's width when not d (a post-encoder's)
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = encoder_output_size
        self.layer_variant = variant = layer_variant or type(self).layer_variant
        self.heads, self.d_k = attention_heads, d // attention_heads
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d, **kw),
                                   AbsolutePositionalEncoding(positional_dropout_rate))

        def layer(i: int) -> nn.Module:
            if variant in CONV_VARIANTS:
                k = conv_kernel_length if isinstance(conv_kernel_length, int) else conv_kernel_length[i]
                return ConvDecoderLayer(d, attention_heads, linear_units, int(k), variant.startswith("dynamic"),
                                        variant.endswith("2d"), conv_wshare, conv_usebias,
                                        src_attention_dropout_rate, dropout_rate, memory_size, **kw)
            if variant == "sim_t":
                return SimTDecoderLayer(d, attention_heads, linear_units, self_attention_dropout_rate,
                                        dropout_rate, **kw)
            return TransformerDecoderLayer(d, attention_heads, linear_units, self_attention_dropout_rate,
                                           src_attention_dropout_rate, dropout_rate, memory_size, **kw)

        self.decoders = nn.ModuleList(layer(i) for i in range(num_blocks))
        self.after_norm = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.output_layer = nn.Linear(d, vocab_size, **kw) if use_output_layer else None

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.after_norm(x)
        return x if self.output_layer is None else self.output_layer(x)

    def _cached(self) -> None:
        """The cache beam steps are the Transformer layer's (the JAX asserts)."""
        if self.layer_variant != "transformer":
            raise ValueError(f"layer_variant {self.layer_variant!r} has no cache beam step: use score_step")

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' floating dtype (LayerNorm weights are never quantised)."""
        return self.after_norm.weight.dtype

    def _embed_step(self, ys: torch.Tensor, pos: int, lc: int) -> torch.Tensor:
        """The (N, 1, D) input of a beam step: token ``ys[:, pos - 1]`` (the
        index clamped into the buffer) at position ``pos - 1``, in the
        model's dtype (a bf16 embedding table under an f32 model:
        ``AbsolutePositionalEncoding``)."""
        p = min(max(pos - 1, 0), ys.shape[1] - 1)
        x = self.embed[0](ys[:, p:p + 1])  # (N, 1, D)
        return self.embed[1].at_position(x, pos - 1, lc, dtype=self.dtype)

    def _run(self, ys, tgt_mask, memory, memory_mask) -> torch.Tensor:
        x = self.embed[1](self.embed[0](ys), dtype=self.dtype)
        at = wider_than(self, memory)
        s1 = None
        for i, layer in enumerate(self.decoders):
            kw = {} if at is None else {"at": layer_at(at, "decoders", i)}
            if self.layer_variant == "sim_t":
                x, s1 = remat.run(layer, x, tgt_mask, memory, memory_mask, s1, **kw)
            else:
                x = remat.run(layer, x, tgt_mask, memory, memory_mask, **kw)
        return (self if at is None else at(x.dtype))._head(x)

    def forward(self, memory, memory_mask, ys_in, ys_in_lengths) -> torch.Tensor:
        """(B, T) tokens -> (B, T, V) logits, causal over each length."""
        b, t = ys_in.shape
        return self._run(ys_in, causal_mask(b, t, ys_in_lengths, device=ys_in.device), memory, memory_mask)

    def score_step(self, memory, memory_mask, ys: torch.Tensor, pos: int) -> torch.Tensor:
        """Log-probs (N, V) of the token at ``pos`` given ``ys[:, :pos]``: the
        whole (N, L) buffer recomputed, the first ``pos`` tokens visible;
        for the other variants the prefix alone (the same log-probs)."""
        if self.layer_variant != "transformer":
            ys = ys[:, :pos]
        b, t = ys.shape
        mask = causal_mask(b, t, device=ys.device) & (torch.arange(t, device=ys.device) < pos)[None, None, :]
        logits = self._run(ys, mask, memory, memory_mask)
        return torch.log_softmax(logits[:, pos - 1], dim=-1)

    def init_cache(self, n: int, max_len: int, dtype=torch.float32, *, device=None):
        """Per-layer zero (K, V) caches (N, H, max_len, dk) for
        ``score_step_cached`` / ``score_step_append``."""
        device = device if device is not None else self.after_norm.weight.device
        return plain_cache(len(self.decoders), n, max_len, self.heads, self.d_k, dtype, device)

    def score_step_cached(self, mem_kv, memory_mask, ys: torch.Tensor, pos: int, cache):
        """Beam step over (N, H, Lc, dk) caches that it writes itself at
        column ``pos - 1`` (in place) -> ((N, V) f32 log-probs, the caches).
        ``mem_kv``: per-layer (K, V) of the memory, N rows."""
        self._cached()
        lc = cache[0][0].shape[2]
        x = self._embed_step(ys, pos, lc)
        self_mask = (torch.arange(lc, device=ys.device) < pos)[None].expand(ys.shape[0], lc)
        at = by_dtype(self)
        for i, ((mk, mv), (ck, cv)) in enumerate(zip(mem_kv, cache)):
            layer = at(x.dtype).decoders[i]
            h = layer.norm1(x)
            k_new, v_new = layer.self_attn.project_kv(h)  # (N, H, 1, dk)
            ck[:, :, pos - 1] = k_new[:, :, 0].to(ck.dtype)
            cv[:, :, pos - 1] = v_new[:, :, 0].to(cv.dtype)
            x = x + layer.self_attn.attend_kv(h, ck, cv, self_mask)
            layer = at(x.dtype).decoders[i]  # f32 past a wider cache
            h = layer.norm2(x)
            x = x + layer.src_attn.attend_kv(h, mk, mv, memory_mask)
            layer = at(x.dtype).decoders[i]  # f32 past a wider memory
            x = x + layer.feed_forward(layer.norm3(x))
        return torch.log_softmax(at(x.dtype)._head(x)[:, 0].float(), dim=-1), cache

    def score_step_append(self, mem_kv, memory_mask, ys: torch.Tensor, pos: int, cache):
        """Cache-read-only beam step (the append protocol) -> ((N, V) f32
        log-probs, per-layer (k_new, v_new) (N, H, 1, dk) columns, which the
        beam's reorder writes: ``decode/beam_search.insert_permute_rows``)."""
        self._cached()
        lc = cache[0][0].shape[2]
        x = self._embed_step(ys, pos, lc)
        cache_mask = (torch.arange(lc, device=ys.device) < pos - 1)[None].expand(ys.shape[0], lc)
        at, new_kv = by_dtype(self), []
        for i, ((mk, mv), (ck, cv)) in enumerate(zip(mem_kv, cache)):
            layer = at(x.dtype).decoders[i]
            h = layer.norm1(x)
            q, k_new, v_new = layer.self_attn.project_qkv(h)
            x = x + layer.self_attn.attend_kv_append(h, ck, cv, k_new, v_new, cache_mask, q_heads=q)
            layer = at(x.dtype).decoders[i]  # f32 past a wider cache
            h = layer.norm2(x)
            x = x + layer.src_attn.attend_kv(h, mk, mv, memory_mask)
            layer = at(x.dtype).decoders[i]  # f32 past a wider memory
            x = x + layer.feed_forward(layer.norm3(x))
            new_kv.append((k_new, v_new))
        return torch.log_softmax(at(x.dtype)._head(x)[:, 0].float(), dim=-1), new_kv

    def init_cache_seg(self, n: int, max_len: int, dtype=torch.float32, num_segments: int = 4, *,
                       device=None):
        """Per-layer (K segments, V segments): ``num_segments`` zero (N, H,
        S, dk) tensors a side, S = ceil(max_len / num_segments)."""
        device = device if device is not None else self.after_norm.weight.device
        seg = -(-max_len // num_segments)
        return [tuple(tuple(torch.zeros((n, self.heads, seg, self.d_k), dtype=dtype, device=device)
                            for _ in range(num_segments)) for _ in range(2))
                for _ in self.decoders]

    @staticmethod
    def gather_cache_seg(cache, g_src: torch.Tensor, pos: int):
        """The beam reorder of a segmented cache: rows ``g_src`` of every
        segment that starts before ``pos``; later segments, never written,
        are kept as they are."""
        seg = cache[0][0][0].shape[2]
        return [tuple(tuple(x[g_src] if pos > i * seg else x for i, x in enumerate(side)) for side in layer)
                for layer in cache]

    def score_step_cached_seg(self, mem_kv, memory_mask, ys: torch.Tensor, pos: int, cache):
        """``score_step_cached`` over a segmented cache: the step's column
        goes into the segment that holds ``pos - 1`` (in place), and the
        attend skips the segments at or past ``pos``. -> ((N, V) f32
        log-probs, the caches)."""
        self._cached()
        seg = cache[0][0][0].shape[2]
        x = self._embed_step(ys, pos, seg * len(cache[0][0]))
        si, off = divmod(pos - 1, seg)
        at = by_dtype(self)
        for i, ((mk, mv), (ks, vs)) in enumerate(zip(mem_kv, cache)):
            layer = at(x.dtype).decoders[i]
            h = layer.norm1(x)
            k_new, v_new = layer.self_attn.project_kv(h)
            if si < len(ks):
                ks[si][:, :, off] = k_new[:, :, 0].to(ks[si].dtype)
                vs[si][:, :, off] = v_new[:, :, 0].to(vs[si].dtype)
            x = x + layer.self_attn.attend_kv_segmented(h, ks, vs, pos, seg)  # in x's dtype, as in JAX
            h = layer.norm2(x)
            x = x + layer.src_attn.attend_kv(h, mk, mv, memory_mask)
            layer = at(x.dtype).decoders[i]  # f32 past a wider memory
            x = x + layer.feed_forward(layer.norm3(x))
        return torch.log_softmax(at(x.dtype)._head(x)[:, 0].float(), dim=-1), cache

    def precompute_memory(self, memory: torch.Tensor):
        """Per-layer cross-attention (K, V), each (B, H, T, dk)."""
        self._cached()
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
        self._cached()
        lc = cache_width(cache)
        x = self._embed_step(ys, pos, lc)
        anc = anc_columns(anc, lc)
        at, new_kv = by_dtype(self), []
        for i, ((mk, mv), (ck, cv)) in enumerate(zip(mem_kv, cache)):
            layer = at(x.dtype).decoders[i]
            h = layer.norm1(x)
            q, k_new, v_new = layer.self_attn.project_qkv(h)  # (N, H, 1, dk)
            x = x + layer.self_attn.attend_kv_anc(ck, cv, k_new, v_new, anc, pos, beam, q,
                                                  width=width, fused=fused)
            layer = at(x.dtype).decoders[i]  # f32 past a wider cache
            h = layer.norm2(x)
            x = x + layer.src_attn.attend_kv_mem_grouped(h, mk, mv, memory_mask, beam)
            layer = at(x.dtype).decoders[i]
            h = layer.norm3(x)
            x = x + layer.feed_forward(h)
            new_kv.append((k_new, v_new))
        logits = at(x.dtype)._head(x)
        return torch.log_softmax(logits[:, 0].float(), dim=-1), new_kv


class MLMDecoder(TransformerDecoder):
    """Mask-CTC's conditional masked LM: non-causal self-attention over the
    valid tokens (its vocabulary holds ``<mask>`` as its last entry)."""

    def forward(self, memory, memory_mask, ys_in, ys_in_lengths) -> torch.Tensor:
        """(B, L) tokens -> (B, L, V) logits, every valid token seeing every
        valid token."""
        tgt_mask = torch.arange(ys_in.shape[1], device=ys_in.device)[None, :] < ys_in_lengths[:, None]
        return self._run(ys_in, tgt_mask, memory, memory_mask)


class SimTDecoder(TransformerDecoder):
    layer_variant = "sim_t"


class SimTMLMDecoder(MLMDecoder):
    """The Mask-CTC MLM decoder of Sim-T layers (the reference's
    ``decoder/sim_t/mlm_decoder.py``)."""

    layer_variant = "sim_t"


class LightConvDecoder(TransformerDecoder):
    layer_variant = "lightconv"


class DynamicConvDecoder(TransformerDecoder):
    layer_variant = "dynamicconv"


class LightConv2DDecoder(TransformerDecoder):
    layer_variant = "lightconv2d"


class DynamicConv2DDecoder(TransformerDecoder):
    layer_variant = "dynamicconv2d"


def anc_columns(anc: torch.Tensor, lc: int) -> torch.Tensor:
    """The first ``lc`` columns of the (N, >=Lc) ancestry table, contiguous,
    taken once per step for all layers of one model."""
    return anc if anc.shape[1] == lc else anc[:, :lc].contiguous()
