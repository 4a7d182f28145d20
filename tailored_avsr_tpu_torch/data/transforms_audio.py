"""Host-side audio transforms (numpy): speed perturbation, noise injection at
controlled SNR, time masking (counterpart of
``tailored_avsr_tpu/data/transforms_audio.py``).

- SpeedRate: sox-style speed change, rate in {0.9, 1.0, 1.1}, as polyphase
  resampling (a playback-rate change: tempo and pitch move together).
- AddNoise: a noise waveform mixed at an SNR drawn from
  {-5, 0, 5, 10, 15, 20, 9999 (off)} dB or a fixed ``snr_target``,
  power-scaled; noise shorter than the utterance is zero-padded.
- TimeMasking: mask up to 0.4 s per second of audio with the mean value.

They run in the host input pipeline (numpy RNG), ahead of the device-side
SpecAug.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence

import numpy as np
from scipy.signal import resample_poly


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            x = t(x)
        return x


class SpeedRate:
    def __init__(self, rates=(0.9, 1.0, 1.1), sample_rate: int = 16000, rng=None):
        self.rates = list(rates)
        self.sample_rate = sample_rate
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        rate = self.rates[self.rng.randint(len(self.rates))]
        if rate == 1.0:
            return x
        frac = Fraction(1.0 / rate).limit_denominator(100)
        return resample_poly(x, frac.numerator, frac.denominator).astype(x.dtype)


def _power(x: np.ndarray) -> float:
    return float(np.mean(x.astype(np.float64) ** 2)) + 1e-12


class AddNoise:
    """Mix a noise waveform at a random (or fixed) SNR. 9999 dB = no noise."""

    def __init__(
        self,
        noise: Optional[np.ndarray] = None,
        snr_levels: Sequence[float] = (-5, 0, 5, 10, 15, 20, 9999),
        snr_target: Optional[float] = None,
        rng=None,
    ):
        self.noise = noise
        self.snr_levels = list(snr_levels)
        self.snr_target = snr_target
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.noise is None:
            return x
        snr = (
            self.snr_target
            if self.snr_target is not None
            else self.snr_levels[self.rng.randint(len(self.snr_levels))]
        )
        if snr == 9999:
            return x
        n = len(x)
        if len(self.noise) <= n:
            # zero-pad short noise to the utterance length: the tail stays
            # clean and the power normalisation sees the zero-diluted noise
            noise = np.concatenate(
                [self.noise, np.zeros(n - len(self.noise), self.noise.dtype)]
            )
        else:
            start = self.rng.randint(len(self.noise) - n)
            noise = self.noise[start : start + n]
        scale = np.sqrt(_power(x) / (_power(noise) * (10.0 ** (snr / 10.0))))
        return (x + scale * noise).astype(x.dtype)


class TimeMasking:
    """Mask up to ``max_mask_seconds`` per second with the signal mean."""

    def __init__(
        self,
        sample_rate: int = 16000,
        max_mask_ratio_per_second: float = 0.4,
        rng=None,
    ):
        self.sample_rate = sample_rate
        self.max_ratio = max_mask_ratio_per_second
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = x.copy()
        seconds = max(1, len(x) // self.sample_rate)
        mean = x.mean()
        for _ in range(seconds):
            width = self.rng.randint(0, int(self.max_ratio * self.sample_rate) + 1)
            if width == 0 or width >= len(x):
                continue
            start = self.rng.randint(0, len(x) - width)
            x[start : start + width] = mean
        return x
