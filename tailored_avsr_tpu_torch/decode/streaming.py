"""Chunked streaming recognition over the contextual-block encoder
(counterpart of ``tailored_avsr_tpu/decode/streaming.py``).

``ContextualBlockStreamer`` takes feature frames as they arrive and
returns, for every block the new frames complete, its encoder frames and
greedy CTC ids. Information crosses block boundaries only through the
per-layer context tokens, which the streamer carries, so the streamed
output is the offline ``ContextualBlockEncoder`` output (up to the order
of the sums of one block against all blocks batched). The host keeps a
numpy tail of raw features: each chunk re-runs the input layer (VALID
convolutions) only over the receptive-field overlap, with the absolute
positional encoding at the chunk's global offset. The streamers run
eagerly, one chunk a call, on the model's device.

``TransducerStreamer`` decodes the emitted frames by the chainable greedy
transducer decode (``ops/rnnt.transducer_greedy_chunk``), carrying the
prediction network's state and last label, so its tokens are the offline
greedy decode's. ``TimesyncStreamer`` advances the frame-synchronous CTC
prefix beam (``decode/ctc_timesync.ctc_timesync_chunk``) chunk by chunk:
each call returns the best partial hypotheses, ``nbest`` the live n-best,
and the final result is the offline time-synchronous search's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from tailored_avsr_tpu_torch.decode.ctc_timesync import ctc_timesync_chunk, timesync_best, timesync_init_state
from tailored_avsr_tpu_torch.models.contextual_block import ContextualBlockEncoder, block_average
from tailored_avsr_tpu_torch.ops.attention import promoted_linear
from tailored_avsr_tpu_torch.ops.posenc import _abs_table, _root
from tailored_avsr_tpu_torch.ops.rnnt import transducer_greedy_chunk
from tailored_avsr_tpu_torch.ops.subsampling import subsampled_length

MAX_POSITIONS = 5000  # the reference's positional-table cap


class ContextualBlockStreamer:
    """Streaming wrapper around an ASR model whose encoder is a
    ``ContextualBlockEncoder`` (input layer ``conv2d`` or ``linear``)::

        st = ContextualBlockStreamer(model)
        st.reset(batch_size=1)
        for chunk in feature_chunks:      # (B, C, F) log-mel frames
            enc, ids = st.accept(chunk)   # may be empty before warm-up
        enc, ids = st.finalize()          # the partial tail, flushed
    """

    def __init__(self, model, max_positions: int = MAX_POSITIONS):
        enc = model.encoder
        if not isinstance(enc, ContextualBlockEncoder):
            raise ValueError("streaming needs encoder 'contextual_block_transformer' or "
                             "'contextual_block_conformer'")
        if enc.pos_enc_layer_type != "abs_pos":
            raise NotImplementedError("streaming supports pos_enc_layer_type 'abs_pos' (the contextual-block "
                                      "registry default)")
        if enc.input_layer == "conv2d":
            self._factor, self._rfield = 4, 7
        elif enc.input_layer == "linear":
            self._factor, self._rfield = 1, 1
        else:
            raise NotImplementedError(f"streaming input_layer {enc.input_layer!r} (use conv2d or linear)")
        self.model, self.enc = model, enc
        self.max_positions = int(max_positions)
        self.hop, self.blk = enc.hop_size, enc.block_size
        self.reset(1)

    @property
    def _weight(self) -> torch.Tensor:
        return self.model.ctc.ctc_lo.weight

    # ------------------------------------------------------------- state --
    def reset(self, batch_size: int) -> None:
        self.batch = batch_size
        self._raw = np.zeros((batch_size, 0, 0), np.float32)  # the feature tail
        self._raw_off = 0  # global index of self._raw[:, 0]
        self._n_raw = 0  # raw frames seen
        self._n_blocks = 0  # blocks emitted
        self._ctx = None  # per-layer context tokens (L, B, D), none before the first block

    def _embedded_len(self, n_raw: int) -> int:
        if self._factor == 1:  # the linear input layer keeps the frame rate
            return n_raw
        return int(subsampled_length(n_raw, self._factor))

    def _empty(self) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self._weight
        return (torch.zeros((self.batch, 0, self.enc.output_size), dtype=w.dtype, device=w.device),
                torch.zeros((self.batch, 0), dtype=torch.long, device=w.device))

    # --------------------------------------------------------- internals --
    def _embed(self, raw: torch.Tensor, e0: int) -> torch.Tensor:
        """The input layer over a raw-feature window, positions from ``e0``."""
        h = self.enc.embed(raw)
        d = h.shape[-1]
        table = _abs_table(self.max_positions, d, h.device, h.dtype)[e0:e0 + h.shape[1]]
        return h * _root(d, h.dtype) + table[None]

    def _block(self, frames: torch.Tensor, bmask: torch.Tensor, first: bool):
        """One block through every layer -> its frames; the per-layer context
        tokens it read are kept for the next block."""
        enc, b = self.enc, frames.shape[0]
        cur = block_average(frames, bmask) if enc.init_average else frames[:, 0]
        ctx = self._ctx if self._ctx is not None else torch.zeros(
            (len(enc.encoders), b, frames.shape[-1]), dtype=frames.dtype, device=frames.device)
        smask = torch.cat([torch.full((b, 1), not first, device=frames.device), bmask,
                           torch.ones((b, 1), dtype=torch.bool, device=frames.device)], dim=1)
        x, new_ctx = frames, []
        for l, layer in enumerate(enc.encoders):
            new_ctx.append(cur)
            out, _ = layer(torch.cat([ctx[l][:, None], x, cur[:, None]], dim=1), None, smask)
            x, cur = out[:, 1:-1], out[:, -1]
        self._ctx = torch.stack(new_ctx)
        return x

    def _run_chunk(self, raw_win: np.ndarray, e0: int, n_blocks: int, tail_valid: int):
        """Embed a window covering embedded frames [e0, e0 + (n_blocks - 1) *
        hop + blk) and run ``n_blocks`` blocks; ``tail_valid`` embedded frames
        are real (fewer only in the flush, where the rest is padding)."""
        hop, blk = self.hop, self.blk
        need = (n_blocks - 1) * hop + blk
        if e0 + need > self.max_positions:
            raise RuntimeError(f"stream exceeds max_positions={self.max_positions} embedded frames (needs "
                               f"{e0 + need}); construct the streamer with a larger max_positions")
        w = self._weight
        with torch.no_grad():
            emb = self._embed(torch.from_numpy(raw_win).to(device=w.device, dtype=w.dtype), e0)
            emb = torch.nn.functional.pad(emb, (0, 0, 0, max(0, need - emb.shape[1])))
            valid = (torch.arange(need, device=w.device) < tail_valid)[None].expand(emb.shape[0], need)
            emb = torch.where(valid[..., None], emb, torch.zeros((), dtype=emb.dtype, device=w.device))
            outs = []
            for i in range(n_blocks):
                sl = slice(i * hop, i * hop + blk)
                outs.append(self._block(emb[:, sl], valid[:, sl], self._n_blocks + i == 0)[:, :hop])
            y = torch.cat(outs, dim=1)
            if self.enc.after_norm is not None:
                y = self.enc.after_norm(y)
            y = torch.where(valid[:, :y.shape[1], None], y, torch.zeros((), dtype=y.dtype, device=w.device))
            return y, self.model.ctc.argmax(y)

    def _accept(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = np.asarray(feats, np.float32)
        if self._raw.shape[2] == 0:
            self._raw = np.zeros((self.batch, 0, feats.shape[2]), np.float32)
        self._raw = np.concatenate([self._raw, feats], axis=1)
        self._n_raw += feats.shape[1]
        n_ready = max(0, (self._embedded_len(self._n_raw) - self.blk) // self.hop + 1) - self._n_blocks
        if n_ready <= 0:
            return self._empty()
        e0 = self._n_blocks * self.hop
        e1 = e0 + (n_ready - 1) * self.hop + self.blk
        r0 = self._factor * e0
        r1 = min(self._n_raw, self._factor * (e1 - 1) + self._rfield)
        win = self._raw[:, r0 - self._raw_off:r1 - self._raw_off]
        out = self._run_chunk(win, e0, n_ready, tail_valid=(n_ready - 1) * self.hop + self.blk)
        self._n_blocks += n_ready
        cut = max(0, self._factor * self._n_blocks * self.hop - self._raw_off)  # the next window's left edge
        self._raw = self._raw[:, cut:]
        self._raw_off += cut
        return out

    def _finalize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        e_avail = self._embedded_len(self._n_raw)
        e_done = self._n_blocks * self.hop
        if e_avail <= e_done:
            return self._empty()
        n_rest = -(-(e_avail - e_done) // self.hop)
        win = self._raw[:, self._factor * e_done - self._raw_off:]
        y, ids = self._run_chunk(win, e_done, n_rest, tail_valid=e_avail - e_done)
        self._n_blocks += n_rest
        emit = e_avail - e_done
        return y[:, :emit], ids[:, :emit]

    # ------------------------------------------------------------ public --
    def accept(self, feats) -> Tuple[np.ndarray, np.ndarray]:
        """Feed (B, C, F) new feature frames -> (encoder frames, CTC ids) of
        every block this chunk completes (possibly none), on the host."""
        y, ids = self._accept(feats)
        return y.float().cpu().numpy(), ids.cpu().numpy()

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flush the partial tail (padded and masked as the offline encoder
        pads it) -> its encoder frames and CTC ids."""
        y, ids = self._finalize()
        return y.float().cpu().numpy(), ids.cpu().numpy()


class TransducerStreamer:
    """Chunked contextual-block encoding + the chainable greedy transducer
    decode: the prediction network's state and the last emitted label carry
    across chunks. Needs a transducer model (joint and prediction
    networks) on a contextual-block encoder."""

    def __init__(self, model, max_symbols_per_frame: int = 3, max_positions: int = MAX_POSITIONS):
        if model.joint_network is None or model.prediction_network is None:
            raise ValueError("TransducerStreamer needs a transducer model (joint + prediction networks)")
        self.model, self.max_symbols = model, int(max_symbols_per_frame)
        self.enc_stream = ContextualBlockStreamer(model, max_positions=max_positions)
        self.reset(1)

    def reset(self, batch_size: int) -> None:
        self.batch = batch_size
        self.enc_stream.reset(batch_size)
        pred = self.model.prediction_network
        last = torch.full((batch_size,), -1, dtype=torch.int32, device=self.enc_stream._weight.device)
        self._carry = (pred.initial_state(batch_size), last)

    def _decode(self, y: torch.Tensor) -> List[List[int]]:
        if y.shape[1] == 0:
            return [[] for _ in range(self.batch)]
        joint, pred = self.model.joint_network, self.model.prediction_network
        valid = torch.full((self.batch,), y.shape[1], dtype=torch.long, device=y.device)
        with torch.no_grad():
            tokens, count, self._carry = transducer_greedy_chunk(
                promoted_linear(joint.lin_enc, y), valid, pred.step, joint.from_projected, self._carry,
                max_symbols_per_frame=self.max_symbols)
        tokens, count = tokens.cpu().numpy(), count.cpu().numpy()
        return [[int(x) for x in tokens[i, :count[i]]] for i in range(self.batch)]

    def accept(self, feats) -> List[List[int]]:
        """Feed (B, C, F) feature frames -> per utterance the token ids the
        completed blocks emit."""
        return self._decode(self.enc_stream._accept(feats)[0])

    def finalize(self) -> List[List[int]]:
        """Flush the encoder tail -> the token ids it emits."""
        return self._decode(self.enc_stream._finalize()[0])


class TimesyncStreamer:
    """Chunked contextual-block encoding + the chainable frame-synchronous
    CTC prefix beam: ``accept`` / ``finalize`` return the best partial
    hypothesis of each utterance, ``nbest`` the live n-best; the final
    result is offline ``ctc_timesync_beam_search``'s over the whole
    utterance."""

    def __init__(self, model, beam_size: int = 10, pre_beam: int = 10, penalty: float = 0.0,
                 max_tokens: int = 200, max_positions: int = MAX_POSITIONS):
        self.model = model
        self.beam_size, self.pre_beam = int(beam_size), int(pre_beam)
        self.penalty, self.max_tokens = float(penalty), int(max_tokens)
        self.enc_stream = ContextualBlockStreamer(model, max_positions=max_positions)
        self.reset(1)

    def reset(self, batch_size: int) -> None:
        self.batch = batch_size
        self.enc_stream.reset(batch_size)
        self._state = timesync_init_state(batch_size, self.beam_size, self.max_tokens,
                                          device=self.enc_stream._weight.device)

    def _advance(self, y: torch.Tensor) -> None:
        if y.shape[1] == 0:
            return
        with torch.no_grad():
            lp = self.model.ctc.log_softmax(y)
            lens = torch.full((self.batch,), lp.shape[1], dtype=torch.long, device=lp.device)
            self._state = ctc_timesync_chunk(lp, lens, self._state, beam_size=self.beam_size,
                                             pre_beam=self.pre_beam, penalty=self.penalty)

    def nbest(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The live (tokens (B, K, L), lengths (B, K), scores (B, K))."""
        toks, lens, scores, _ = timesync_best(self._state)
        return toks.cpu().numpy(), lens.cpu().numpy(), scores.cpu().numpy()

    def _best_partial(self) -> List[List[int]]:
        toks, lens, _ = self.nbest()
        return [[int(x) for x in toks[i, 0, :lens[i, 0]]] for i in range(self.batch)]

    def accept(self, feats) -> List[List[int]]:
        """Feed (B, C, F) feature frames -> the best partial hypothesis of
        each utterance so far."""
        self._advance(self.enc_stream._accept(feats)[0])
        return self._best_partial()

    def finalize(self) -> List[List[int]]:
        """Flush the encoder tail -> the final best hypotheses."""
        self._advance(self.enc_stream._finalize()[0])
        return self._best_partial()
