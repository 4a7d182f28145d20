"""Multi-head attention: the decoder's and the LM's absolute MHA with its
beam-step forms, and the encoder's relative-position self-attention
(counterpart of ``tailored_avsr_tpu/ops/attention.py:58-412`` and
``:480-603``).

Rel-pos routing follows the JAX module: with ``use_flash`` outside training
and a key-side mask, the in-kernel rel-pos flash kernel (K1) runs once the
materialised (B, H, T, T) bias would reach 32 MiB, and below that the bias
is built here and streamed through the flash kernel (K2). Otherwise the
eager formulation runs. The 32 MiB switch was measured on the TPU and is
kept so both kernels sit on the serving path. On the H100 bf16 K1 is the
faster route at both of the flagship's request shapes (T = 100 and 500:
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


class MultiHeadedAttention(nn.Module):
    """Scaled dot-product multi-head attention (``linear_q/k/v/out``).

    ``mask`` may be (B, Tk) key-side or (B, Tq, Tk) pairwise (causal
    decoding). Heads are (B, H, T, dk), split from the model axis heads-major.
    """

    def __init__(self, num_heads: int, dropout_rate: float = 0.0, model_dim: int = 256,
                 *, device=None, dtype=None):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(f"model_dim {model_dim} is not a multiple of num_heads {num_heads}")
        kw = {"device": device, "dtype": dtype}
        self.h, self.d_k = num_heads, model_dim // num_heads
        self.linear_q = nn.Linear(model_dim, model_dim, **kw)
        self.linear_k = nn.Linear(model_dim, model_dim, **kw)
        self.linear_v = nn.Linear(model_dim, model_dim, **kw)
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
        q = self._heads(self.linear_q(query))
        k = self._heads(self.linear_k(key))
        v = self._heads(self.linear_v(value))
        scores = (q @ k.transpose(-2, -1)) / math.sqrt(self.d_k)
        attn = _masked_softmax(scores, mask).to(v.dtype)
        out = self.dropout(attn) @ v
        return self.linear_out(self._merge(out)), attn

    def project_kv(self, x: torch.Tensor):
        """(B, T, D) -> heads-form key and value (B, H, T, dk)."""
        return self._heads(self.linear_k(x)), self._heads(self.linear_v(x))

    def _qkv_params(self):
        """The concatenated q/k/v weight and bias, rebuilt only when a
        parameter was replaced or written in place (the beam loop calls this
        every step)."""
        params = [m.weight for m in (self.linear_q, self.linear_k, self.linear_v)]
        params += [m.bias for m in (self.linear_q, self.linear_k, self.linear_v)]
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
        return self.linear_out(out.transpose(1, 2).reshape(n, 1, h * dk))

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


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL style relative-position MHA with learned u/v biases.

    ``pos_emb`` is the (1, 2T-1, D) table from ``RelPositionalEncoding``.
    """

    def __init__(
        self,
        size: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        use_flash: bool = False,
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
        p = self._heads(self.linear_pos(pos_emb))  # (1, H, 2T-1, dk)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)

        flash_ok = self.use_flash and not self.training and (mask is None or mask.dim() == 2)
        bias_bytes = b * self.h * t * t * q.element_size()
        if flash_ok and bias_bytes >= FLASH_RELPOS_MIN_BIAS_BYTES:
            from tailored_avsr_tpu_torch.ops.flash_attention import flash_attention_relpos

            out = flash_attention_relpos(
                q_u.contiguous(), k.contiguous(), v.contiguous(), q_v.contiguous(),
                p[0].contiguous(), mask,
            )
        else:
            matrix_bd = rel_shift(q_v @ p.transpose(-2, -1))  # (B, H, T, T)
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
