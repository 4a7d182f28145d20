"""Multi-head attention: the absolute MHA (the decoder's and the LM's, with
their beam-step forms, and the ``selfattn`` encoder self-attention under a
(B, T) key mask or Longformer's (B, T, T) band), the encoder's
relative-position self-attention, and Fastformer's additive attention
(counterpart of ``tailored_avsr_tpu/ops/attention.py:58-412`` and
``:480-660``).

Rel-pos routing follows the JAX module: with ``use_flash`` outside training
and a key-side mask, the in-kernel rel-pos flash kernel (K1) runs once the
materialised (B, H, T, T) bias would reach 32 MiB, and below that the bias
is built here and streamed through the flash kernel (K2). The legacy shift
and ``zero_triu`` always build their bias and take K2: K1 computes the
"latest" shift of a (2T-1)-row table and nothing else. Otherwise the eager
formulation runs. The 32 MiB switch was measured on the TPU and is kept so
both kernels sit on the serving path. On the H100 bf16 K1 is the faster
route at both of the flagship's request shapes (T = 100 and 500:
``chip_smoke.py`` times it beside the built bias streamed through K2).

The beam step's self-attention over the ancestry cache
(``MultiHeadedAttention.attend_kv_anc``) launches the group-attend kernel
(K4, or K6 over an int8 cache, ``ops/group_attend.py``) for CUDA tensors
unless ``fused=False``. An int8 cache or memory side arrives as an (int8
payload, f32 per-column scale) tuple (``ops/kv_quant.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from tailored_avsr_tpu_torch.ops.masking import MASK_MIN

FLASH_RELPOS_MIN_BIAS_BYTES = 32 * 1024 * 1024


def _masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 softmax over the last axis of (B, H, Tq, Tk) scores with a (B, Tk)
    key-side or (B, Tq, Tk) pairwise mask (True = valid); fully masked rows
    give zeros."""
    scores = scores.float()
    if mask is None:
        return torch.softmax(scores, dim=-1)
    m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None, :, :]
    attn = torch.softmax(scores.masked_fill(~m, MASK_MIN), dim=-1)
    return attn.masked_fill(~m, 0.0)


def promoted_linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` computed in the wider of x's and m's types, as a flax Dense
    promotes its input and kernel: a group attend over a cache wider than
    the model (``cache_dtype: float32`` under bf16) returns f32. A
    tensor-parallel linear (``parallel/tensor_parallel.py``) promotes itself."""
    if x.dtype == m.weight.dtype or getattr(m, "tensor_parallel", False):
        return m(x)
    dt = torch.promote_types(x.dtype, m.weight.dtype)
    return F.linear(x.to(dt), m.weight.to(dt), None if m.bias is None else m.bias.to(dt))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the wider of the two types, as ``jnp.einsum`` promotes:
    bf16 queries over an f32 memory or cache give f32 scores."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product multi-head attention (``linear_q/k/v/out``).

    ``mask`` may be (B, Tk) key-side or (B, Tq, Tk) pairwise (causal
    decoding). Heads are (B, H, T, dk), split from the model axis heads-major.
    """

    def __init__(self, num_heads: int, dropout_rate: float = 0.0, model_dim: int = 256,
                 kv_dim: Optional[int] = None, *, device=None, dtype=None):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(f"model_dim {model_dim} is not a multiple of num_heads {num_heads}")
        kw = {"device": device, "dtype": dtype}
        self.h, self.d_k = num_heads, model_dim // num_heads
        kv_dim = kv_dim or model_dim  # the keys' and values' input width (a post-encoder's memory)
        self.linear_q = nn.Linear(model_dim, model_dim, **kw)
        self.linear_k = nn.Linear(kv_dim, model_dim, **kw)
        self.linear_v = nn.Linear(kv_dim, model_dim, **kw)
        self.linear_out = nn.Linear(model_dim, model_dim, **kw)
        self.dropout = nn.Dropout(dropout_rate)
        self._qkv = (None, None)  # (key of the q/k/v parameters, fused weight and bias)

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape(y.shape[:-1] + (self.h, self.d_k)).transpose(1, 2)

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        """(B, H, T, dk) -> (B, T, H*dk), heads-major."""
        b, _, t, _ = out.shape
        return out.transpose(1, 2).reshape(b, t, self.h * self.d_k)

    def forward(self, query, key, value, mask=None) -> torch.Tensor:
        return self.attend(query, key, value, mask)[0]

    def attend(self, query, key, value, mask=None):
        """Full forward -> (output (B, Tq, D), attention (B, H, Tq, Tk))."""
        q = self._heads(promoted_linear(self.linear_q, query))
        k = self._heads(promoted_linear(self.linear_k, key))
        v = self._heads(promoted_linear(self.linear_v, value))
        scores = matmul(q, k.transpose(-2, -1)) / math.sqrt(self.d_k)
        attn = _masked_softmax(scores, mask).to(v.dtype)
        out = self.dropout(attn) @ v
        return promoted_linear(self.linear_out, self._merge(out)), attn

    def project_kv(self, x: torch.Tensor):
        """(B, T, D) -> heads-form key and value (B, H, T, dk)."""
        return self._heads(promoted_linear(self.linear_k, x)), self._heads(promoted_linear(self.linear_v, x))

    def _qkv_params(self):
        """The concatenated q/k/v weight and bias, rebuilt only when a
        parameter was replaced or written in place (the beam loop calls this
        every step). Quantised weights (``utils/quantize.py``) dequantise at
        each access, and are concatenated each call."""
        mods = (self.linear_q, self.linear_k, self.linear_v)
        params = [m.weight for m in mods] + [m.bias for m in mods]
        if any(parametrize.is_parametrized(m) for m in mods):
            return torch.cat(params[:3]), torch.cat(params[3:])
        key = tuple((p.data_ptr(), p._version, p.dtype) for p in params)
        if self._qkv[0] != key:
            with torch.no_grad():
                self._qkv = (key, (torch.cat(params[:3]), torch.cat(params[3:])))
        return self._qkv[1]

    def project_qkv(self, x: torch.Tensor):
        """One fused (D -> 3D) projection -> heads-form (q, k, v); the same
        sums per output element as ``linear_q/k/v``."""
        w, b = self._qkv_params()
        q, k, v = F.linear(x, w, b).chunk(3, dim=-1)
        return self._heads(q), self._heads(k), self._heads(v)

    def attend_kv(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single-query attention of (B, 1, D) inputs over cached (B, H, T, dk)
        keys and values with a (B, T) key mask -> (B, 1, D)."""
        q = self._heads(promoted_linear(self.linear_q, query))  # (B, H, 1, dk)
        scores = matmul(q, k.transpose(-2, -1)).float() / math.sqrt(self.d_k)
        attn = _masked_softmax(scores, mask).to(v.dtype)
        return promoted_linear(self.linear_out, self._merge(attn @ v))

    def attend_kv_append(
        self,
        query: torch.Tensor,  # (B, 1, D) single-step input
        k: torch.Tensor,  # (B, H, T, dk) cached keys, the step's column not written
        v: torch.Tensor,  # (B, H, T, dk) cached values
        k_new: torch.Tensor,  # (B, H, 1, dk) this step's key column
        v_new: torch.Tensor,  # (B, H, 1, dk) this step's value column
        mask: Optional[torch.Tensor] = None,  # (B, T) cache-column validity
        q_heads: Optional[torch.Tensor] = None,  # precomputed (B, H, 1, dk) query heads
    ) -> torch.Tensor:
        """Single-query attention over the cache plus the step's own column,
        appended logically (the append protocol writes it afterwards, in the
        beam's reorder: ``decode/beam_search.insert_permute_rows``) -> (B, 1, D)."""
        q = q_heads if q_heads is not None else self._heads(promoted_linear(self.linear_q, query))
        scale = 1.0 / math.sqrt(self.d_k)
        s_cache = matmul(q, k.transpose(-2, -1)).float() * scale  # (B, H, 1, T)
        s_new = matmul(q, k_new.transpose(-2, -1)).float() * scale  # (B, H, 1, 1)
        scores = torch.cat([s_cache, s_new], dim=-1)
        if mask is not None:
            mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=-1)
        attn = _masked_softmax(scores, mask).to(v.dtype)
        out = attn[..., :-1] @ v + attn[..., -1:] * v_new
        return promoted_linear(self.linear_out, self._merge(out))

    def attend_kv_segmented(self, query: torch.Tensor, k_segs, v_segs, pos: int, seg_len: int) -> torch.Tensor:
        """Single-query attention over a length-segmented cache (sequences of
        (B, H, S, dk) segments, rows < ``pos`` valid) by an online softmax
        carried across the segments; a segment at or past ``pos`` is skipped
        (a host ``if``: ``pos`` is a host integer). -> (B, 1, D), the
        unsegmented attend's result up to the order of the sums."""
        q = self._heads(promoted_linear(self.linear_q, query))  # (B, H, 1, dk)
        b, h = q.shape[:2]
        scale = 1.0 / math.sqrt(self.d_k)
        m = torch.full((b, h, 1, 1), MASK_MIN, device=q.device)
        lsum = torch.zeros((b, h, 1, 1), device=q.device)
        acc = torch.zeros((b, h, 1, self.d_k), device=q.device)
        for si, (k, v) in enumerate(zip(k_segs, v_segs)):
            lo = si * seg_len
            if pos <= lo:
                continue
            s = matmul(q, k.transpose(-2, -1)).float() * scale  # (B, H, 1, S)
            valid = (torch.arange(seg_len, device=q.device) + lo < pos)[None, None, None, :]
            s = torch.where(valid, s, MASK_MIN)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new) * valid
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + (p.to(v.dtype) @ v).float()
            m = m_new
        out = (acc / torch.clamp(lsum, min=1e-30)).to(query.dtype)
        return self.linear_out(self._merge(out))

    def apply_scores(self, values: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        """Project ``values`` (B, Tk, D) and weight them by precomputed
        (B, H, Tq, Tk) attention scores -> (B, Tq, D), no output projection
        (the Sim-T decoder's post-attention)."""
        v = self._heads(promoted_linear(self.linear_v, values))
        return self._merge(self.dropout(scores.to(v.dtype)) @ v)

    def attend_kv_anc(
        self,
        k,  # (B, H, beam, Lc, dk) group-major cached keys, or (int8 payload, (B, H, beam, Lc) scale)
        v,  # (B, H, beam, Lc, dk) cached values, or (int8 payload, scale)
        k_new: torch.Tensor,  # (N, H, 1, dk) this step's key column
        v_new: torch.Tensor,  # (N, H, 1, dk) this step's value column
        anc: torch.Tensor,  # (N, >=Lc) ancestry: column t of row n lives in slot anc[n, t]
        pos: int,  # cache columns < pos-1 are live
        beam: int,
        q_heads: torch.Tensor,  # (N, H, 1, dk) query heads
        width: Optional[int] = None,  # attend only cache columns [0, width)
        fused: Optional[bool] = None,  # None / True: K4 / K6 for CUDA tensors; False: plain
    ) -> torch.Tensor:
        """Single-query attention of every beam row over its group's
        never-reordered cache, resolved through ``anc``; the step's own column
        joins the softmax. -> (N, 1, D). CPU tensors always take the plain
        formulation (the JAX XLA path; over an int8 cache, its dequantising
        twin)."""
        from tailored_avsr_tpu_torch.ops import group_attend as ga

        quantized = isinstance(k, tuple)
        cache = (*k, *v) if quantized else (k, v)  # (k, [k_scale,] v, [v_scale])
        b, h, km, lc, dk = cache[0].shape
        n = b * beam
        if anc.shape[1] < lc:  # pad columns never written: -1 matches no slot
            anc = F.pad(anc, (0, lc - anc.shape[1]), value=-1)
        ancg = anc[:, :lc].reshape(b, beam, lc).contiguous()
        args = (*cache, ga.to_group(q_heads, beam), ga.to_group(k_new, beam), ga.to_group(v_new, beam),
                ancg, pos)
        if quantized:
            attend = ga.group_attend_anc_q_plain if fused is False else ga.group_attend_anc_q
        else:
            attend = ga.group_attend_anc_plain if fused is False else ga.group_attend_anc
        out = attend(*args, width=width)  # (B, H, beam, dk)
        return promoted_linear(self.linear_out, out.transpose(1, 2).reshape(n, 1, h * dk))

    def attend_kv_mem_grouped(
        self,
        query: torch.Tensor,  # (N, 1, D) single-step queries, N = B*beam
        k,  # (B, H, T, dk) memory keys shared by each beam group, or (int8 payload, (B, H, T) scale)
        v,  # (B, H, T, dk), or (int8 payload, scale)
        mask: Optional[torch.Tensor],  # (B, T) key validity
        beam: int,
    ) -> torch.Tensor:
        """Cross-attention of every beam row over its group's encoder memory,
        read once per group instead of once per row. -> (N, 1, D). With
        ``mem_dtype: int8`` the key scales fold into the f32 scores and the
        value scales into the softmax weights, rounding where the JAX
        package rounds."""
        k_scale = v_scale = None
        if isinstance(k, tuple):
            (k, k_scale), (v, v_scale) = k, v
        n = query.shape[0]
        b = n // beam
        q = self._heads(self.linear_q(query))  # (N, H, 1, dk)
        qg = q[:, :, 0].reshape(b, beam, self.h, self.d_k).transpose(1, 2)  # (B, H, i, dk)
        scores = (qg @ k.to(qg.dtype).transpose(-2, -1)) / math.sqrt(self.d_k)  # (B, H, i, T)
        if k_scale is not None:
            scores = scores.float() * k_scale[:, :, None, :]
        attn = _masked_softmax(scores, mask)
        if v_scale is not None:
            attn = attn * v_scale[:, :, None, :]
        out = attn.to(qg.dtype) @ v.to(qg.dtype)  # (B, H, i, dk)
        return self.linear_out(out.transpose(1, 2).reshape(n, 1, self.h * self.d_k))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T); out[..., i, j] = x[..., i, T-1-i+j]."""
    b, h, t, _ = x.shape
    x = torch.nn.functional.pad(x, (1, 0))  # (b, h, t, 2t)
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :]  # (b, h, 2t-1, t)
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


def legacy_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL's original shift of (B, H, T, T) scores against the
    legacy (T-row) table: out[..., i, j] = x[..., i, T-1-(i-j)] for j <= i;
    the entries with j > i are the fold's artifacts, as in the legacy
    espnet code."""
    b, h, t, _ = x.shape
    x = torch.nn.functional.pad(x, (1, 0))  # (b, h, t, t+1)
    return x.reshape(b, h, t + 1, t)[:, :, 1:, :].reshape(b, h, t, t)


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL style relative-position MHA with learned u/v biases.

    ``pos_emb`` is the (1, 2T-1, D) table from ``RelPositionalEncoding``, or
    with ``legacy`` the (1, T, D) table from ``LegacyRelPositionalEncoding``
    (espnet's pre-2020 ``legacy_rel_selfattn``). ``zero_triu`` zeroes the
    positional term above the diagonal.
    """

    def __init__(
        self,
        size: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        use_flash: bool = False,
        zero_triu: bool = False,
        legacy: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        if size % num_heads:
            raise ValueError(f"size {size} is not a multiple of num_heads {num_heads}")
        kw = {"device": device, "dtype": dtype}
        self.h, self.d_k = num_heads, size // num_heads
        self.use_flash = use_flash
        self.zero_triu, self.legacy = zero_triu, legacy
        self.linear_q = nn.Linear(size, size, **kw)
        self.linear_k = nn.Linear(size, size, **kw)
        self.linear_v = nn.Linear(size, size, **kw)
        self.linear_out = nn.Linear(size, size, **kw)
        self.linear_pos = nn.Linear(size, size, bias=False, **kw)
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, self.d_k, **kw))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, self.d_k, **kw))
        self.dropout = nn.Dropout(dropout_rate)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1, self.h, self.d_k).transpose(1, 2)

    def positional_bias(self, q_v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The (B, H, T, T) positional term: the shifted q_v . p^T, zeroed
        above the diagonal under ``zero_triu``."""
        bd = q_v @ p.transpose(-2, -1)
        bd = legacy_rel_shift(bd) if self.legacy else rel_shift(bd)
        if self.zero_triu:
            t = bd.shape[-2]
            bd = bd * torch.ones((t, t), dtype=bd.dtype, device=bd.device).tril()
        return bd

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        pos_emb: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, t, d = query.shape
        q = self._heads(self.linear_q(query))  # (B, H, T, dk)
        k = self._heads(self.linear_k(key))
        v = self._heads(self.linear_v(value))
        p = self._heads(self.linear_pos(pos_emb))  # (1, H, 2T-1 | T, dk)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)

        flash_ok = self.use_flash and not self.training and (mask is None or mask.dim() == 2)
        in_kernel = not (self.legacy or self.zero_triu)  # K1 computes the "latest" shift only
        bias_bytes = b * self.h * t * t * q.element_size()
        if flash_ok and in_kernel and bias_bytes >= FLASH_RELPOS_MIN_BIAS_BYTES:
            from tailored_avsr_tpu_torch.ops.flash_attention import flash_attention_relpos

            out = flash_attention_relpos(
                q_u.contiguous(), k.contiguous(), v.contiguous(), q_v.contiguous(),
                p[0].contiguous(), mask,
            )
        else:
            matrix_bd = self.positional_bias(q_v, p)  # (B, H, T, T)
            if flash_ok:
                from tailored_avsr_tpu_torch.ops.flash_attention import flash_attention

                out = flash_attention(
                    q_u.contiguous(), k.contiguous(), v.contiguous(),
                    bias=matrix_bd.contiguous(), mask=mask,
                )
            else:
                scores = (q_u @ k.transpose(-2, -1) + matrix_bd) / math.sqrt(self.d_k)
                attn = self.dropout(_masked_softmax(scores, mask).to(v.dtype))
                out = attn @ v
        return self.linear_out(out.transpose(1, 2).reshape(b, t, d))


class FastSelfAttention(nn.Module):
    """Fastformer additive attention (``fast_selfattn``): a per-head
    attention-pooled global query modulates the keys, whose pooled summary
    modulates the values; linear in T. The pooling softmax is f32 with
    ``MASK_MIN`` at padded frames, whose weights are then zeroed; the output
    adds the projected query (``query``, ``query_att``, ``key``,
    ``key_att``, ``value``, ``transform``)."""

    def __init__(self, size: int, num_heads: int, dropout_rate: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        if size % num_heads:
            raise ValueError(f"size {size} is not a multiple of num_heads {num_heads}")
        kw = {"device": device, "dtype": dtype}
        self.h, self.d_k = num_heads, size // num_heads
        self.query = nn.Linear(size, size, **kw)
        self.query_att = nn.Linear(size, num_heads, **kw)
        self.key = nn.Linear(size, size, **kw)
        self.key_att = nn.Linear(size, num_heads, **kw)
        self.value = nn.Linear(size, size, **kw)
        self.transform = nn.Linear(size, size, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def _pool(self, scores: torch.Tensor, heads: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, H) scores, (B, H, T, dk) heads -> (B, H, dk), pooled over T."""
        s = scores.transpose(1, 2).float() / math.sqrt(self.d_k)
        if mask is not None:
            w = torch.softmax(s.masked_fill(~mask[:, None, :], MASK_MIN), dim=-1).masked_fill(~mask[:, None, :], 0.0)
        else:
            w = torch.softmax(s, dim=-1)
        return self.dropout(torch.einsum("bht,bhtd->bhd", w.to(heads.dtype), heads))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        split = lambda y: y.reshape(b, t, self.h, self.d_k).transpose(1, 2)  # noqa: E731
        query = self.query(x)
        pooled_q = self._pool(self.query_att(query), split(query), mask)  # (B, H, dk)
        mixed = self.key(x) * pooled_q.reshape(b, 1, d)
        pooled_k = self._pool(self.key_att(mixed), split(mixed), mask)
        weighted = split(self.value(x)) * pooled_k[:, :, None, :]
        return self.dropout(self.transform(weighted.transpose(1, 2).reshape(b, t, d))) + query
