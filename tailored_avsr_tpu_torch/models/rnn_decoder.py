"""The LSTM attention decoder, espnet's ``rnn`` decoder choice (counterpart
of ``tailored_avsr_tpu/models/rnn_decoder.py``).

Embedding -> stacked LSTM cells whose input is the token's embedding and a
location-aware attention context -> vocabulary projection. A step
(``step``, the JAX ``_RNNAttStep``): the previous alignment goes through
``loc_conv`` (2 * ``aconv_filts`` + 1 taps, zero ``same`` padding),
``mlp_att``; the first layer's previous hidden state through ``mlp_dec``;
the score is ``gvec(tanh(q + mlp_enc(memory) + f))``, -1e10 past each
utterance's frames, softmaxed in f32 after the sharpening factor 2.0 and
cast to the memory's dtype; the context feeds ``lstm_0`` beside the
embedding. The first alignment is uniform over the valid frames; the
carries start at zero in the memory's dtype. Every product runs in the
wider of its operands' types, as flax promotes: over an RNN encoder's f32
memory a bf16 decoder's attention, cells and output run in f32. Key grammar: ``embed.0``,
``mlp_enc``, ``output_layer``, ``step.{loc_conv, mlp_att, mlp_dec, gvec,
lstm_i}``, each ``lstm_i`` an ``ops/rnnt.LSTMLayer`` (torch's packed
layout, flax's per-product promotion).

``score_step`` recomputes the recurrence over the prefix ``ys[:, :pos]``
only: the JAX step runs it over the whole buffer, whose later steps never
reach the log-probs of position ``pos``. There is no cache beam step, as
in the JAX package (``layer_variant`` ``rnn``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.ops.attention import promoted_linear
from tailored_avsr_tpu_torch.ops.rnnt import LSTMLayer

NEG_SCORE = -1e10  # the JAX step's fill past the valid frames


class RNNAttStep(nn.Module):
    """One decode step: location-aware attention, then the LSTM stack."""

    def __init__(self, embed_size: int, memory_size: int, hidden_size: int, num_layers: int, att_dim: int,
                 aconv_chans: int, aconv_filts: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.loc_conv = nn.Conv1d(1, aconv_chans, 2 * aconv_filts + 1, padding=aconv_filts, bias=False, **kw)
        self.mlp_att = nn.Linear(aconv_chans, att_dim, bias=False, **kw)
        self.mlp_dec = nn.Linear(hidden_size, att_dim, bias=False, **kw)
        self.gvec = nn.Linear(att_dim, 1, bias=False, **kw)
        for i in range(num_layers):
            setattr(self, f"lstm_{i}", LSTMLayer(embed_size + memory_size if i == 0 else hidden_size, hidden_size,
                                                 **kw))

    def forward(self, states, att_prev, memory, enc_proj, memory_mask, x_t):
        """(states: per layer (c, h) (B, H); att_prev (B, T)) and the step's
        (B, E) input -> (new states, new alignment, top layer's h)."""
        conv = self.loc_conv
        dt = torch.promote_types(att_prev.dtype, conv.weight.dtype)
        f = F.conv1d(att_prev[:, None, :].to(dt), conv.weight.to(dt), padding=conv.padding)
        f = promoted_linear(self.mlp_att, f.transpose(1, 2))  # (B, T, att)
        q = promoted_linear(self.mlp_dec, states[0][1])  # the first layer's previous hidden state
        e = promoted_linear(self.gvec, torch.tanh(q[:, None] + enc_proj + f))[..., 0]  # (B, T)
        if memory_mask is not None:
            e = torch.where(memory_mask, e, NEG_SCORE)
        w = torch.softmax(2.0 * e.float(), dim=-1).to(memory.dtype)
        if memory_mask is not None:
            w = torch.where(memory_mask, w, torch.zeros((), dtype=w.dtype, device=w.device))
        ctx = torch.einsum("bt,btd->bd", w, memory)
        dt = torch.promote_types(x_t.dtype, ctx.dtype)  # jnp.concatenate promotes
        h = torch.cat([x_t.to(dt), ctx.to(dt)], dim=-1)
        new = []
        for i, st in enumerate(states):
            st = getattr(self, f"lstm_{i}").cell(h, st)
            new.append(st)
            h = st[1]
        return tuple(new), w, h


class RNNDecoder(nn.Module):
    layer_variant = "rnn"

    def __init__(
        self,
        vocab_size: int,
        encoder_output_size: int = 256,
        hidden_size: int = 320,
        num_layers: int = 1,
        dropout_rate: float = 0.0,
        att_dim: int = 320,
        aconv_chans: int = 10,
        aconv_filts: int = 100,
        layer_variant: str = "rnn",
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layer_variant = layer_variant
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.embed = nn.Sequential(nn.Embedding(vocab_size, hidden_size, **kw))
        self.mlp_enc = nn.Linear(encoder_output_size, att_dim, bias=False, **kw)
        self.output_layer = nn.Linear(hidden_size, vocab_size, **kw)
        self.dropout = nn.Dropout(dropout_rate)
        self.step = RNNAttStep(hidden_size, encoder_output_size, hidden_size, num_layers, att_dim, aconv_chans,
                               aconv_filts, **kw)

    def _hidden(self, memory, memory_mask, ys_in) -> torch.Tensor:
        """The teacher-forced recurrence -> (B, L, H), the top layer's h."""
        b, t = ys_in.shape[0], memory.shape[1]
        emb = self.dropout(self.embed[0](ys_in))
        enc_proj = promoted_linear(self.mlp_enc, memory)
        zeros = memory.new_zeros((b, self.hidden_size))
        states = tuple((zeros, zeros) for _ in range(self.num_layers))
        if memory_mask is not None:
            att = memory_mask.to(memory.dtype) / torch.clamp(memory_mask.sum(-1, keepdim=True), min=1)
        else:
            att = torch.full((b, t), 1.0 / t, dtype=memory.dtype, device=memory.device)
        hs = []
        for u in range(ys_in.shape[1]):
            states, att, h = self.step(states, att, memory, enc_proj, memory_mask, emb[:, u])
            hs.append(h)
        return self.dropout(torch.stack(hs, dim=1))

    def forward(self, memory, memory_mask, ys_in, ys_in_lengths) -> torch.Tensor:
        """(B, L) tokens -> (B, L, V) logits (padded positions are the loss's
        to mask)."""
        return promoted_linear(self.output_layer, self._hidden(memory, memory_mask, ys_in))

    def score_step(self, memory, memory_mask, ys: torch.Tensor, pos: int) -> torch.Tensor:
        """f32 log-probs (N, V) of the token at ``pos`` given ``ys[:, :pos]``."""
        h = self._hidden(memory, memory_mask, ys[:, :pos])[:, -1]
        return F.log_softmax(promoted_linear(self.output_layer, h).float(), dim=-1)
