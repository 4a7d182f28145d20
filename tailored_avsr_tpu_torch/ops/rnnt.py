"""RNN-Transducer: the loss, the joint and prediction networks and the greedy
decoders (counterpart of ``tailored_avsr_tpu/ops/rnnt.py``).

- ``rnnt_loss`` / ``multiblank_rnnt_loss``: the JAX package's formulation
  of the forward DP in plain PyTorch, a loop over T of one
  ``torch.logcumsumexp`` over the label axis,
      alpha[t, u] = cum_e[u] + LCE_k(alpha[t-1, k] + blank[t-1, k] - cum_e[k]),
  with the same ``NEG_INF = -1e30`` arithmetic (with -inf the
  ``a - cum_e`` term would give NaN). Autograd gives the gradients.
- ``JointNetwork``: ``lin_out(act(lin_enc(enc) + lin_dec(pred)))``;
  ``lin_enc`` carries the bias, ``lin_dec`` none.
- ``PredictionNetwork``: token embedding, dropout, a stack of one-layer
  LSTMs (``LSTMLayer``) in torch's packed layout, gates i, f, g, o. The
  flax ``OptimizedLSTMCell`` has its bias on the h side only: here
  ``bias_hh_l0`` is the trained bias and ``bias_ih_l0`` a buffer (zeros
  unless a reference checkpoint sets it; the cell adds the two, as
  ``torch.nn.LSTM`` does). ``step`` maps label -1 to a zero embedding.
- ``transducer_greedy_chunk`` (chainable ``(state, last_emit)`` carry),
  ``transducer_greedy_decode`` and ``multiblank_greedy_decode``: the JAX
  scans become Python loops of the same length with ``torch.where``
  updates, so no step reads the device from the host; the multi-blank
  ``while_loop`` runs to its bound (T * (max_symbols + 1) steps) and
  leaves early only once every utterance has consumed its frames, read on
  the host once every T steps.

The JAX package computes all of this outside any Pallas kernel, and so does
the port: no kernel of ``csrc/`` runs here.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.ops.attention import promoted_linear
from tailored_avsr_tpu_torch.parallel.host_data import global_rows

NEG_INF = -1.0e30

State = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # per layer (c, h), each (B, H)


def _emit_and_blank(logits, labels, label_lengths, blank_id: int):
    """f32 (blank (B, T, U+1), emit (B, T, U)) log-probs; emit is NEG_INF at
    label positions >= the label length."""
    b, t, u1, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    blank = logp[..., blank_id]
    safe = torch.where(labels >= 0, labels, 0).long()
    emit = logp[:, :, :-1, :].gather(-1, safe[:, None, :, None].expand(b, t, u1 - 1, 1)).squeeze(-1)
    u_valid = torch.arange(u1 - 1, device=logits.device)[None, :] < label_lengths[:, None]
    return logp, blank, emit, u_valid


def _pad_cum(emit: torch.Tensor) -> torch.Tensor:
    """(B, T, U) -> (B, T, U+1): column u holds the sum of emit[..., :u]."""
    return F.pad(emit.cumsum(dim=-1), (1, 0))


def rnnt_loss(
    logits: torch.Tensor,  # (B, T, U+1, V) joint-network outputs
    logit_lengths: torch.Tensor,  # (B,) valid encoder frames
    labels: torch.Tensor,  # (B, U) label ids (>= 0 where valid)
    label_lengths: torch.Tensor,  # (B,)
    blank_id: int = 0,
) -> torch.Tensor:
    """Batch-mean RNN-T negative log-likelihood (f32)."""
    b, t = logits.shape[:2]
    _, blank, emit, u_valid = _emit_and_blank(logits, labels, label_lengths, blank_id)
    emit = torch.where(u_valid[:, None, :], emit, NEG_INF)
    cum = _pad_cum(emit)  # (B, T, U+1)
    alpha = cum[:, 0]  # alpha[0, u] = sum of emit[0, :u]
    alphas = [alpha]
    for ti in range(1, t):
        alpha = cum[:, ti] + torch.logcumsumexp(alpha + blank[:, ti - 1] - cum[:, ti], dim=-1)
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # (T, B, U+1)
    rows = torch.arange(b, device=logits.device)
    t_last = (logit_lengths.long() - 1).clamp(0, t - 1)
    u_last = label_lengths.long()
    nll = -(alphas[t_last, rows, u_last] + blank[rows, t_last, u_last])
    return nll.sum() / global_rows(b)


def multiblank_rnnt_loss(
    logits: torch.Tensor,  # (B, T, U+1, V)
    logit_lengths: torch.Tensor,  # (B,)
    labels: torch.Tensor,  # (B, U)
    label_lengths: torch.Tensor,  # (B,)
    blank_id: int,
    durations: Sequence[int],  # big-blank durations, each > 1: durations[i] at index blank_id - 1 - i
    sigma: float = 0.05,
) -> torch.Tensor:
    """Batch-mean multi-blank RNN-T negative log-likelihood (f32), as
    ``tailored_avsr_tpu/ops/rnnt.py:77``: every transition under-normalised
    by ``sigma``; a big blank of duration d reads alpha[t - d], and the
    likelihood ends through any blank that lands exactly on frame T."""
    durations = tuple(int(d) for d in durations)
    if not durations or any(d <= 1 for d in durations):
        raise ValueError(f"multi-blank durations must be > 1, got {durations}")
    b, t, u1, _ = logits.shape
    dmax = max(durations)
    logp, blank, emit, u_valid = _emit_and_blank(logits, labels, label_lengths, blank_id)
    emit = torch.where(u_valid[:, None, :], emit - sigma, NEG_INF)
    blank = blank - sigma
    bbs = [logp[..., blank_id - 1 - i] - sigma for i in range(len(durations))]
    cum = _pad_cum(emit)
    hist = [cum[:, 0]] + [torch.full_like(cum[:, 0], NEG_INF)] * (dmax - 1)  # hist[k] = alpha[t-1-k]
    alphas = [cum[:, 0]]
    for ti in range(1, t):
        a_in = hist[0] + blank[:, ti - 1]
        for i, d in enumerate(durations):  # a big blank from frame ti - d (none before frame 0)
            bb = bbs[i][:, ti - d] if ti >= d else torch.full_like(a_in, NEG_INF)
            a_in = torch.logaddexp(a_in, hist[d - 1] + bb)
        alpha = cum[:, ti] + torch.logcumsumexp(a_in - cum[:, ti], dim=-1)
        hist = [alpha] + hist[:-1]
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    rows = torch.arange(b, device=logits.device)
    lengths = logit_lengths.long()
    t_last = (lengths - 1).clamp(0, t - 1)
    u_last = label_lengths.long()
    ll = alphas[t_last, rows, u_last] + blank[rows, t_last, u_last]
    for i, d in enumerate(durations):
        t_d = (lengths - d).clamp(0, t - 1)  # a big blank from T - d lands exactly on T
        term = alphas[t_d, rows, u_last] + bbs[i][rows, t_d, u_last]
        ll = torch.logaddexp(ll, torch.where(lengths - d >= 0, term, NEG_INF))
    return -ll.sum() / global_rows(b)


class JointNetwork(nn.Module):
    """joint(enc, pred) = lin_out(act(lin_enc(enc) + lin_dec(pred)))."""

    def __init__(self, vocab_size: int, encoder_size: int, decoder_size: int, joint_dim: int = 320,
                 activation: str = "tanh", *, device=None, dtype=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"unknown joint activation: {activation!r} (tanh or relu)")
        kw = {"device": device, "dtype": dtype}
        self.lin_enc = nn.Linear(encoder_size, joint_dim, **kw)
        self.lin_dec = nn.Linear(decoder_size, joint_dim, bias=False, **kw)
        self.lin_out = nn.Linear(joint_dim, vocab_size, **kw)
        self.act = torch.tanh if activation == "tanh" else F.relu

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """enc (..., T, 1, D) x pred (..., 1, U+1, D') broadcast -> (..., T, U+1, V)."""
        return self.from_projected(promoted_linear(self.lin_enc, enc), pred)

    def from_projected(self, enc_proj: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """The joint from ``lin_enc(enc)``, which a decoder computes once for
        every frame instead of once a step. Each product runs in the wider
        of its operands' types, as flax promotes (f32 encoder frames under
        bf16 weights give an f32 joint)."""
        return promoted_linear(self.lin_out, self.act(enc_proj + promoted_linear(self.lin_dec, pred)))


class LSTMLayer(nn.Module):
    """One LSTM layer in torch's packed layout (``weight_ih_l0`` (4H, in),
    ``weight_hh_l0`` (4H, H), gates i, f, g, o), the bias trained on the h
    side only as in flax's ``OptimizedLSTMCell`` (``bias_ih_l0`` is a
    buffer)."""

    def __init__(self, input_size: int, hidden_size: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.hidden_size = hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden_size, input_size, **kw))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden_size, hidden_size, **kw))
        self.register_buffer("bias_ih_l0", torch.zeros(4 * hidden_size, **kw))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * hidden_size, **kw))

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """(..., in) -> (..., 4H): the input side ``x @ W_ih + b_ih`` in the
        type flax promotes x and W_ih to, for any leading shape."""
        dt = torch.promote_types(x.dtype, self.weight_ih_l0.dtype)
        return F.linear(x.to(dt), self.weight_ih_l0.to(dt), self.bias_ih_l0.to(dt))

    def recurrent_weights(self, h_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """W_hh and b_hh in the type flax promotes the recurrent side
        ``h @ W_hh + b`` to, for an h of ``h_dtype``."""
        w_hh, b_hh = self.weight_hh_l0, self.bias_hh_l0
        dt = torch.promote_types(torch.promote_types(h_dtype, w_hh.dtype), b_hh.dtype)
        return w_hh.to(dt), b_hh.to(dt)

    @staticmethod
    def _step(gx: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor], w_hh: torch.Tensor,
              b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(c, h) -> (c', h') from the input side ``gx`` and the recurrent
        weights in their promoted type."""
        c, h = state
        i, f, g, o = (gx + F.linear(h.to(w_hh.dtype), w_hh, b_hh)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def cell(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, in), (c, h) -> (c', h'), each side in the type flax's cell
        promotes it to (``input_gates``, ``recurrent_weights``). They differ
        only under bf16 weight storage (``utils/quantize.py``), where a bf16
        embedding meets a bf16 input kernel and that product is rounded to
        bf16; else one fused ``torch.lstm_cell``."""
        c, h = state
        w_hh, b_hh = self.recurrent_weights(h.dtype)
        dt = w_hh.dtype
        if torch.promote_types(x.dtype, self.weight_ih_l0.dtype) == dt:
            h, c = torch.lstm_cell(x.to(dt), (h.to(dt), c.to(dt)), self.weight_ih_l0.to(dt), w_hh,
                                   self.bias_ih_l0.to(dt), b_hh)
            return c, h
        return self._step(self.input_gates(x), state, w_hh, b_hh)

    def sequence(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T, H), every step's h, from zero carries in f32
        (flax's ``initialize_carry`` takes the cell's f32 ``param_dtype``,
        whatever type the weights are stored in): the input side of all T
        steps in one product, then the recurrence step by step."""
        gx = self.input_gates(x)
        w_hh, b_hh = self.recurrent_weights(torch.float32)
        state = (torch.zeros((x.shape[0], self.hidden_size), dtype=torch.float32, device=x.device),) * 2
        outs = []
        for t in range(x.shape[1]):
            state = self._step(gx[:, t], state, w_hh, b_hh)
            outs.append(state[1])
        return torch.stack(outs, dim=1)


class PredictionNetwork(nn.Module):
    """LSTM label-prediction network: ``embed`` and the layers ``decoder.{i}``
    (the reference's espnet ``TransducerDecoder`` key grammar)."""

    def __init__(self, vocab_size: int, embed_dim: int = 256, hidden_dim: int = 256, num_layers: int = 1,
                 dropout_rate: float = 0.1, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.hidden_dim = hidden_dim
        self.embed = nn.Embedding(vocab_size, embed_dim, **kw)
        self.decoder = nn.ModuleList(
            LSTMLayer(embed_dim if i == 0 else hidden_dim, hidden_dim, **kw) for i in range(num_layers))
        self.dropout = nn.Dropout(dropout_rate)

    def initial_state(self, batch: int) -> State:
        w = self.decoder[0].bias_hh_l0  # the LSTM's type (an embedding may be stored in bf16)
        zeros = torch.zeros((batch, self.hidden_dim), dtype=w.dtype, device=w.device)
        return tuple((zeros, zeros) for _ in self.decoder)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, U) ignore-padded labels -> (B, U+1, H): row 0 after the zero
        start embedding, row u after label u."""
        b = labels.shape[0]
        x = self.embed(torch.where(labels >= 0, labels, 0).long())  # (B, U, E)
        x = self.dropout(F.pad(x, (0, 0, 1, 0)))  # the start token embeds to zeros
        for layer in self.decoder:
            zeros = layer.bias_hh_l0.new_zeros(b, self.hidden_dim)
            state = (zeros, zeros)
            outs = []
            for u in range(x.shape[1]):
                state = layer.cell(x[:, u], state)
                outs.append(state[1])
            x = torch.stack(outs, dim=1)
        return x

    def step(self, state: State, label: torch.Tensor) -> Tuple[State, torch.Tensor]:
        """One decode step: (state, (N,) label; -1 = start) -> (new state, (N, H))."""
        x = self.embed(label.clamp(min=0).long())
        x = torch.where((label >= 0)[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        new = []
        for layer, st in zip(self.decoder, state):
            st = layer.cell(x, st)
            new.append(st)
            x = st[1]
        return tuple(new), x


def select_state(emit: torch.Tensor, new: State, old: State) -> State:
    """Per row, the new state where ``emit`` else the old one."""
    m = emit[:, None]
    return tuple((torch.where(m, nc, oc), torch.where(m, nh, oh)) for (nc, nh), (oc, oh) in zip(new, old))


def _write_at(tokens: torch.Tensor, count: torch.Tensor, sym: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """``sym`` into column ``count`` of each emitting row of (B, L) ``tokens``."""
    at = torch.arange(tokens.shape[1], device=tokens.device)[None, :] == count[:, None]
    return torch.where(emit[:, None] & at, sym[:, None], tokens)


def transducer_greedy_chunk(
    enc: torch.Tensor,  # (B, Tc, D) encoder frames of this chunk (as joint_apply takes them)
    valid_lengths: torch.Tensor,  # (B,) valid frames within the chunk
    pred_apply: Callable,  # (state, label (B,)) -> (state, (B, H))
    joint_apply: Callable,  # (enc_t (B, D), g (B, H)) -> (B, V) logits
    carry,  # (pred_state, last_emit (B,)): chainable across chunks
    max_symbols_per_frame: int = 3,
    blank_id: int = 0,
):
    """One chunk of greedy transducer decoding with a chainable carry: up to
    ``max_symbols_per_frame`` symbols a frame, the frame ending at its first
    blank. Returns (tokens (B, Tc * max_symbols) int32, counts (B,), new carry)."""
    b, t, _ = enc.shape
    lmax = t * max_symbols_per_frame
    state, last = carry
    tokens = torch.zeros((b, lmax), dtype=torch.int32, device=enc.device)
    count = torch.zeros((b,), dtype=torch.int32, device=enc.device)
    for ti in range(t):
        enc_t = enc[:, ti]
        stop = ti >= valid_lengths  # this frame is padding
        for _ in range(max_symbols_per_frame):
            new_state, g = pred_apply(state, last)
            sym = joint_apply(enc_t, g).argmax(dim=-1).to(torch.int32)
            stop = stop | (sym == blank_id)
            emit = ~stop & (count < lmax)
            tokens = _write_at(tokens, count, sym, emit)
            count = count + emit.to(torch.int32)
            last = torch.where(emit, sym, last)
            state = select_state(emit, new_state, state)
    return tokens, count, (state, last)


def transducer_greedy_decode(
    enc: torch.Tensor,  # (B, T, D)
    enc_lengths: torch.Tensor,
    pred_apply: Callable,
    joint_apply: Callable,
    init_state: State,
    max_symbols_per_frame: int = 3,
    blank_id: int = 0,
):
    """Greedy transducer decode with a symbols-per-frame cap.
    Returns (tokens (B, T * max_symbols), lengths (B,))."""
    last0 = torch.full((enc.shape[0],), -1, dtype=torch.int32, device=enc.device)  # -1: start
    tokens, count, _ = transducer_greedy_chunk(enc, enc_lengths, pred_apply, joint_apply, (init_state, last0),
                                               max_symbols_per_frame, blank_id)
    return tokens, count


def multiblank_greedy_decode(
    enc: torch.Tensor,  # (B, T, D)
    enc_lengths: torch.Tensor,  # (B,)
    pred_apply: Callable,
    joint_apply: Callable,
    init_state: State,
    blank_id: int,
    durations: Sequence[int],  # durations[i] <-> vocabulary index blank_id - 1 - i
    max_symbols_per_frame: int = 3,
):
    """Multi-blank greedy transducer decode: a label emits and advances the
    prediction network, the blank advances one frame and a big blank
    ``<blank{d}>`` d frames; after ``max_symbols_per_frame`` emissions on a
    frame a label advances one frame instead. Per-utterance frame pointers,
    up to T * (max_symbols + 1) steps. Returns (tokens (B, T * max_symbols),
    counts (B,))."""
    b, t, _ = enc.shape
    dev = enc.device
    lmax = t * max_symbols_per_frame
    max_iters = t * (max_symbols_per_frame + 1)
    n_big = len(durations)
    dur_vec = torch.tensor([1] + [int(d) for d in durations], dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    t_ptr = torch.zeros((b,), dtype=torch.int32, device=dev)
    state = init_state
    last = torch.full((b,), -1, dtype=torch.int32, device=dev)
    tokens = torch.zeros((b, lmax), dtype=torch.int32, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    since_adv = torch.zeros((b,), dtype=torch.int32, device=dev)
    for it in range(max_iters):
        if it and it % t == 0 and not bool((t_ptr < enc_lengths).any()):
            break  # every utterance is done: the remaining steps change nothing
        active = t_ptr < enc_lengths
        enc_t = enc[rows, t_ptr.clamp(0, t - 1).long()]
        new_state, g = pred_apply(state, last)
        sym = joint_apply(enc_t, g).argmax(dim=-1).to(torch.int32)
        off = blank_id - sym  # 0: the blank, 1..: big blanks
        is_blank = (off >= 0) & (off <= n_big)
        dt = torch.where(is_blank, dur_vec[off.clamp(0, n_big).long()], 0)
        forced = since_adv >= max_symbols_per_frame
        dt = torch.where(forced & ~is_blank, 1, dt)
        emit = active & ~is_blank & ~forced & (count < lmax)
        tokens = _write_at(tokens, count, sym, emit)
        count = count + emit.to(torch.int32)
        last = torch.where(emit, sym, last)
        state = select_state(emit, new_state, state)
        t_ptr = t_ptr + torch.where(active, dt, 0).to(torch.int32)
        since_adv = torch.where(dt > 0, 0, since_adv + emit.to(torch.int32)).to(torch.int32)
    return tokens, count
