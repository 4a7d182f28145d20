"""Audio frontend: waveform -> STFT -> power -> log-mel filterbank.

Counterpart of ``LogMelFrontend`` in ``tailored_avsr_tpu/ops/frontend_audio.py``.
Framing, the Hann window zero-padded to ``n_fft``, the rFFT power spectrum,
the mel projection and the log floor all run in f32 whatever the input
dtype; the result is handed back in the input dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def hann_window(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """(n_fft//2+1, n_mels) Slaney-style mel filterbank (librosa-compatible)."""
    if fmax is None:
        fmax = sr / 2.0
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        fsafe = np.maximum(f, 1e-10)
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(fsafe / min_log_hz) / logstep, f / f_sp
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(
            m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m
        )

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2.0, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_freqs), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def stft_num_frames(num_samples: torch.Tensor, hop_length: int) -> torch.Tensor:
    """torch.stft center=True frame count: 1 + floor(S / hop)."""
    return num_samples // hop_length + 1


class LogMelFrontend(nn.Module):
    def __init__(
        self,
        fs: int = 16000,
        n_fft: int = 512,
        win_length: int = 400,
        hop_length: int = 160,
        n_mels: int = 80,
        fmin: float = 0.0,
        fmax: Optional[float] = None,
        log_floor: float = 1e-10,
    ):
        super().__init__()
        self.n_fft, self.hop_length, self.n_mels = n_fft, hop_length, n_mels
        self.log_floor = log_floor
        lpad = (n_fft - win_length) // 2
        # f32 constants kept off the module's buffers so that casting the
        # model to bf16 leaves them in f32, as the JAX frontend does
        self._window = np.pad(hann_window(win_length), (lpad, n_fft - win_length - lpad))
        self._mel = mel_filterbank(fs, n_fft, n_mels, fmin, fmax)
        self._consts: dict = {}

    def output_size(self) -> int:
        return self.n_mels

    def _constants(self, device: torch.device):
        if device not in self._consts:
            self._consts[device] = (
                torch.from_numpy(self._window).to(device),
                torch.from_numpy(self._mel).to(device),
            )
        return self._consts[device]

    def forward(self, speech: torch.Tensor, lengths: torch.Tensor):
        """(B, S) waveform, (B,) sample lengths -> (B, T', n_mels), (B,) int32 T'."""
        window, mel_mat = self._constants(speech.device)
        pad = self.n_fft // 2
        x = F.pad(speech.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.n_fft, self.hop_length) * window  # (B, T', n_fft)
        spec = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        power = spec.real.square() + spec.imag.square()
        logmel = torch.log(torch.clamp(power @ mel_mat, min=self.log_floor))
        out_lens = stft_num_frames(lengths, self.hop_length).to(torch.int32)
        return logmel.to(speech.dtype), out_lens


class SlidingWindowFrontend(nn.Module):
    """Raw-waveform frames (espnet's ``SlidingWindow``): (B, S) samples ->
    (B, T', ``win_length``) windows every ``hop_length`` samples, with no
    transform; a pure gather, so the input dtype is kept. T' = 1 + (S -
    win) // hop, and each length 1 + (len - win) // hop, at least 0."""

    def __init__(self, win_length: int = 400, hop_length: int = 160):
        super().__init__()
        self.win_length, self.hop_length = win_length, hop_length

    def output_size(self) -> int:
        return self.win_length

    def forward(self, speech: torch.Tensor, lengths: torch.Tensor):
        frames = speech.unfold(-1, self.win_length, self.hop_length)  # (B, T', win)
        out_lens = torch.clamp(1 + torch.div(lengths - self.win_length, self.hop_length, rounding_mode="floor"),
                               min=0).to(torch.int32)
        return frames, out_lens


class FusedFrontend(nn.Module):
    """Several audio frontends fused on the feature axis (espnet's
    ``FusedFrontends``, ``align_method: linear_projection``). Each entry of
    ``frontends`` is a sub-frontend's config with its ``frontend_type``
    (``default`` log-mel or ``sliding_window``). With g the gcd of the hop
    lengths and factor_i = hop_i // g, sub-frontend i's (B, T_i, D_i)
    features go through ``proj{i}`` (D_i -> factor_i * ``proj_dim``) and
    are reshaped to (B, T_i * factor_i, ``proj_dim``); the streams are cut
    to the shortest and concatenated, so ``output_size()`` is
    ``len(frontends) * proj_dim``. The lengths are each stream's scaled
    lengths, the smallest of them, at most the cut."""

    def __init__(self, frontends=(), align_method: str = "linear_projection", proj_dim: int = 100,
                 *, device=None, dtype=None):
        super().__init__()
        if align_method != "linear_projection":
            raise NotImplementedError(f"fused frontend align_method={align_method!r}: espnet and this port "
                                      "implement only 'linear_projection'")
        if not frontends:
            raise ValueError("fused frontend needs at least one sub-frontend")
        self.proj_dim, self.n_frontends = proj_dim, len(frontends)
        subs = []
        for conf in frontends:
            conf = dict(conf)
            kind = conf.pop("frontend_type", "default")
            if kind == "default":
                keep = ("fs", "n_fft", "win_length", "hop_length", "n_mels", "fmin", "fmax")
                subs.append(LogMelFrontend(**{k: v for k, v in conf.items() if k in keep}))
            elif kind == "sliding_window":
                subs.append(SlidingWindowFrontend(**{k: v for k, v in conf.items()
                                                     if k in ("win_length", "hop_length")}))
            else:
                raise NotImplementedError(f"fused sub-frontend '{kind}' needs external pretrained weights, "
                                          "which are not part of this repository; use 'default' or "
                                          "'sliding_window'")
        self.subs = subs  # no parameters: kept out of the module tree, as in the key grammar
        g = int(np.gcd.reduce([f.hop_length for f in subs]))
        self.factors = tuple(f.hop_length // g for f in subs)
        for i, (sub, factor) in enumerate(zip(subs, self.factors)):
            setattr(self, f"proj{i}", nn.Linear(sub.output_size(), factor * proj_dim, device=device, dtype=dtype))

    def output_size(self) -> int:
        return self.n_frontends * self.proj_dim

    def forward(self, speech: torch.Tensor, lengths: torch.Tensor):
        feats, lens = [], []
        for i, (sub, factor) in enumerate(zip(self.subs, self.factors)):
            x, xl = sub(speech, lengths)  # (B, T_i, D_i)
            x = getattr(self, f"proj{i}")(x)  # (B, T_i, factor * proj_dim)
            b, t, _ = x.shape
            feats.append(x.reshape(b, t * factor, self.proj_dim))
            lens.append(xl * factor)
        m = min(x.shape[1] for x in feats)
        out = torch.cat([x[:, :m] for x in feats], dim=-1)
        out_lens = torch.clamp(torch.stack(lens).amin(0), max=m).to(torch.int32)
        return out, out_lens
