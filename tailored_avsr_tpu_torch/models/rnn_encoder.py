"""The (Bi)LSTM encoder, espnet's ``rnn`` and ``vgg_rnn`` encoder choices
(counterpart of ``tailored_avsr_tpu/models/rnn_encoder.py``).

With ``use_vgg`` the features first pass VGG2L: two blocks of [3x3 conv,
ReLU, 3x3 conv, ReLU, 2x2 max-pool] over the (T, F) plane (64 then 128
channels, zero ``same`` padding, the pools flooring odd sizes), flattened
to (B, T / 4, 128 * F / 4), and the lengths become ``ilens // 4``, at
least 1. Then ``num_layers`` LSTM layers, forward and, when
``bidirectional``, backward, each direction's output concatenated; a
projection with tanh after each layer (``proj_i``; after the last alone
without ``use_projection``, to ``output_size``), dropout, and the frames
past each length set to zero.

The backward direction reverses each utterance within its own length, as
flax's ``nn.RNN(reverse=True, keep_order=True, seq_lengths=...)`` does, so
no valid output reads a padded frame. Each layer's input projection covers
every frame in one product, and only the recurrence loops over time. The
cells carry the flax tree's names, ``OptimizedLSTMCell_{n}`` in creation
order: layer i's forward cell is n = 2i and its backward one 2i + 1 (n =
i when unidirectional). Every product runs in the type flax promotes its
operands to: the carries start at zero in f32, as flax's do (its
``param_dtype``), so each LSTM returns f32 whatever the weights are stored
in, and under a bf16 model the projections and every later layer run in
f32, as in JAX. The encoder hands its f32 output on, as the JAX one does:
the CTC head, the decoders (their cross-attention, then the rest of the
step on their weights upcast) and the beam's caches, which take the
memory's dtype, run in f32 on the bf16 weights.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.models import remat
from tailored_avsr_tpu_torch.ops.attention import promoted_linear
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask
from tailored_avsr_tpu_torch.ops.rnnt import LSTMLayer

VGG_CHANNELS = (64, 128)


def reverse_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) with each row's first ``lengths[b]`` steps reversed and the
    rest in place (its own inverse)."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    n = lengths.to(device=x.device, dtype=torch.long)[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape))


class RNNEncoder(nn.Module):
    def __init__(
        self,
        input_size: int = 80,
        output_size: int = 320,
        hidden_size: int = 320,
        num_layers: int = 4,
        bidirectional: bool = True,
        use_projection: bool = True,
        dropout_rate: float = 0.0,
        use_vgg: bool = False,
        interctc_layer_idx: Sequence[int] = (),
        interctc_use_conditioning: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.output_size, self.num_layers = output_size, num_layers
        self.bidirectional, self.use_vgg = bidirectional, use_vgg
        self.conditioning_layer = None  # the JAX encoder takes the interCTC keys and taps nothing
        feats = input_size
        if use_vgg:
            cin = 1
            for j, ch in enumerate(VGG_CHANNELS):
                setattr(self, f"vgg_conv{j}a", nn.Conv2d(cin, ch, 3, padding=1, **kw))
                setattr(self, f"vgg_conv{j}b", nn.Conv2d(ch, ch, 3, padding=1, **kw))
                cin = ch
                feats //= 2
            feats *= VGG_CHANNELS[-1]
        directions = 2 if bidirectional else 1
        n = 0
        for i in range(num_layers):
            for _ in range(directions):
                setattr(self, f"OptimizedLSTMCell_{n}", LSTMLayer(feats, hidden_size, **kw))
                n += 1
            last = i == num_layers - 1
            if use_projection or last:
                setattr(self, f"proj_{i}", nn.Linear(directions * hidden_size,
                                                     output_size if last else hidden_size, **kw))
                feats = hidden_size
            else:
                feats = directions * hidden_size
        self.dropout = nn.Dropout(dropout_rate)

    def _vgg(self, xs: torch.Tensor) -> torch.Tensor:
        v = xs[:, None]  # (B, 1, T, F)
        for j in range(len(VGG_CHANNELS)):
            v = F.relu(getattr(self, f"vgg_conv{j}a")(v))
            v = F.relu(getattr(self, f"vgg_conv{j}b")(v))
            v = F.max_pool2d(v, 2)
        b, c, t, f = v.shape
        return v.permute(0, 2, 3, 1).reshape(b, t, f * c)  # flax's (T, F, C) flattening

    def _layer(self, i: int, h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        directions = 2 if self.bidirectional else 1
        outs = []
        for d in range(directions):
            cell = getattr(self, f"OptimizedLSTMCell_{directions * i + d}")
            x = reverse_within(h, lengths) if d else h
            y = cell.sequence(x)
            outs.append(reverse_within(y, lengths) if d else y)
        h = torch.cat(outs, dim=-1) if directions > 1 else outs[0]
        proj = getattr(self, f"proj_{i}", None)
        if proj is not None:
            h = torch.tanh(promoted_linear(proj, h))
        return self.dropout(h)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor, generator: Optional[torch.Generator] = None,
                ctc=None):
        """(B, T, F) features -> (encoder_out (B, T', output_size), lengths,
        aux with no interCTC taps and no branch weights)."""
        h, lengths = xs, ilens
        if self.use_vgg:
            h = self._vgg(h)
            lengths = torch.clamp(lengths // 4, min=1)
        for i in range(self.num_layers):
            h = remat.run(self._layer, i, h, lengths)
        mask = make_valid_mask(lengths, h.shape[1])
        h = torch.where(mask[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
        return h, lengths, {"intermediate_outs": [], "branch_weights": []}
