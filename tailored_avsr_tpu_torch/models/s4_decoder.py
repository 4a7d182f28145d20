"""The S4 decoder, espnet's ``s4`` decoder choice (counterpart of
``tailored_avsr_tpu/models/s4_decoder.py``).

An autoregressive decoder whose sequence mixer is a diagonal state-space
layer (S4D): per block ``x += s4(norms1(x))``, ``x += src_attn(norms2(x),
memory)``, ``x += ffn(norms3(x))``, then ``after_norm`` and
``output_layer``, each block's modules named ``s4_i``, ``src_attn_i``,
``ffn_i``, ``norms{1,2,3}_i`` as the flax tree names them.

``S4DLayer``: per channel c a ZOH-discretised diagonal SSM (A = -exp(
log_A_real) + i A_imag, dt = exp(log_dt), B = 1), its T-tap kernel
K[c, k] = 2 Re sum_n C[c, n] B_bar[c, n] A_bar[c, n]^k built by the
Vandermonde product in f32 complex, applied as a causal depthwise
convolution, then the D skip and SiLU in f32 and a cast back to the
input's dtype. The block runs outside autocast: the JAX layer computes
in f32 whatever its input.

``score_step`` recomputes the prefix ``ys[:, :pos]`` only (the mixer is
causal); there is no cache beam step, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.models import remat
from tailored_avsr_tpu_torch.models.decoder import wider_than
from tailored_avsr_tpu_torch.ops.attention import MultiHeadedAttention
from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward
from tailored_avsr_tpu_torch.ops.posenc import AbsolutePositionalEncoding

_LN_EPS = 1e-6  # flax LayerNorm default


class S4DLayer(nn.Module):
    """``log_dt`` (C,), ``log_A_real``, ``A_imag``, ``C_re``, ``C_im`` (C,
    N), ``D`` (C,); the initial values (``utils/initialize.init_params_``):
    dt log-uniform in [dt_min, dt_max], A = -1/2 + i pi n, C normal with
    variance 1/2, D = 1."""

    def __init__(self, channels: int, d_state: int = 64, dt_min: float = 1e-3, dt_max: float = 1e-1, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.dt_min, self.dt_max = dt_min, dt_max
        self.log_dt = nn.Parameter(torch.empty(channels, **kw))
        self.log_A_real = nn.Parameter(torch.empty(channels, d_state, **kw))
        self.A_imag = nn.Parameter(torch.empty(channels, d_state, **kw))
        self.C_re = nn.Parameter(torch.empty(channels, d_state, **kw))
        self.C_im = nn.Parameter(torch.empty(channels, d_state, **kw))
        self.D = nn.Parameter(torch.empty(channels, **kw))

    def kernel(self, t: int) -> torch.Tensor:
        """The (C, T) convolution kernel, f32."""
        dt = torch.exp(self.log_dt.float())[:, None]
        a = torch.complex(-torch.exp(self.log_A_real.float()), self.A_imag.float())
        dt_a = dt * a
        b_bar = (torch.exp(dt_a) - 1.0) / a
        cc = torch.complex(self.C_re.float(), self.C_im.float())
        vander = torch.exp(dt_a[:, :, None] * torch.arange(t, device=a.device))  # (C, N, T)
        return 2.0 * torch.einsum("cn,cnt->ct", cc * b_bar, vander).real

    def forward(self, u: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        b, t, c = u.shape
        with torch.autocast(u.device.type, enabled=False):
            uf = u.float()
            # y[i] = sum_{k <= i} K[c, k] u[i - k]: the cross-correlation of the
            # flipped kernel over T - 1 zeros and the sequence
            y = F.conv1d(F.pad(uf.transpose(1, 2), (t - 1, 0)), self.kernel(t).flip(-1)[:, None, :], groups=c)
            y = y.transpose(1, 2) + uf * self.D.float()
            return F.silu(y).to(u.dtype)


class S4Decoder(nn.Module):
    layer_variant = "s4"

    def __init__(
        self,
        vocab_size: int,
        encoder_output_size: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 6,
        d_state: int = 64,
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.1,
        src_attention_dropout_rate: float = 0.0,
        layer_variant: str = "s4",
        memory_size: Optional[int] = None,  # the memory's width when not d (a post-encoder's)
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = encoder_output_size
        self.layer_variant, self.num_blocks = layer_variant, num_blocks
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d, **kw),
                                   AbsolutePositionalEncoding(positional_dropout_rate))
        for i in range(num_blocks):
            setattr(self, f"s4_{i}", S4DLayer(d, d_state, **kw))
            setattr(self, f"src_attn_{i}",
                    MultiHeadedAttention(attention_heads, src_attention_dropout_rate, d, memory_size, **kw))
            setattr(self, f"ffn_{i}", PositionwiseFeedForward(d, linear_units, dropout_rate, "relu", **kw))
            for n in (1, 2, 3):
                setattr(self, f"norms{n}_{i}", nn.LayerNorm(d, eps=_LN_EPS, **kw))
        self.after_norm = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.output_layer = nn.Linear(d, vocab_size, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    @property
    def dtype(self) -> torch.dtype:
        return self.after_norm.weight.dtype

    def _block(self, i: int, x, memory, memory_mask, at=None):
        m = self if at is None else at(x.dtype)
        x = x + m.dropout(getattr(m, f"s4_{i}")(getattr(m, f"norms1_{i}")(x)))
        h = getattr(m, f"norms2_{i}")(x)
        x = x + m.dropout(getattr(m, f"src_attn_{i}")(h, memory, memory, memory_mask))
        m = self if at is None else at(x.dtype)  # f32 past a wider memory
        return x + m.dropout(getattr(m, f"ffn_{i}")(getattr(m, f"norms3_{i}")(x)))

    def _run(self, memory, memory_mask, ys):
        """-> (the blocks' normalised output, the module of its dtype)."""
        x = self.embed[1](self.embed[0](ys), dtype=self.dtype)
        at = wider_than(self, memory)
        for i in range(self.num_blocks):
            x = remat.run(self._block, i, x, memory, memory_mask, at)
        m = self if at is None else at(x.dtype)
        return m.after_norm(x), m

    def forward(self, memory, memory_mask, ys_in, ys_in_lengths) -> torch.Tensor:
        """(B, L) tokens -> (B, L, V) logits (padded positions are the loss's
        to mask)."""
        h, m = self._run(memory, memory_mask, ys_in)
        return m.output_layer(h)

    def score_step(self, memory, memory_mask, ys: torch.Tensor, pos: int) -> torch.Tensor:
        """f32 log-probs (N, V) of the token at ``pos`` given ``ys[:, :pos]``."""
        h, m = self._run(memory, memory_mask, ys[:, :pos])
        return F.log_softmax(m.output_layer(h[:, -1]).float(), dim=-1)


def s4_initial_values(layer: S4DLayer, generator: torch.Generator) -> dict:
    """The JAX layer's initial values (``s4_decoder.py:56-76``) for
    ``layer``'s shapes, drawn from ``generator`` on the CPU."""
    c, n = layer.log_A_real.shape
    lo, hi = math.log(layer.dt_min), math.log(layer.dt_max)
    return {
        "log_dt": torch.rand(c, generator=generator) * (hi - lo) + lo,
        "log_A_real": torch.full((c, n), math.log(0.5)),
        "A_imag": (math.pi * torch.arange(n, dtype=torch.float32)).expand(c, n),
        "C_re": torch.randn((c, n), generator=generator) * 0.5 ** 0.5,
        "C_im": torch.randn((c, n), generator=generator) * 0.5 ** 0.5,
        "D": torch.ones(c),
    }
