"""Host-side video transforms (numpy) for lip-ROI streams (T, H, W)
(counterpart of ``tailored_avsr_tpu/data/transforms_video.py``): Normalise
(applied twice: /250, then the dataset's mean and std), TimeMasking
(<= 0.4 s per second, mean frame), CenterCrop 88x88, RandomCrop 88x88,
HorizontalFlip(0.5), QuantizeUint8, VideoSpeedRate.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tailored_avsr_tpu_torch.data.transforms_audio import Compose  # same composition op

FPS = 25


class Normalise:
    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x.astype(np.float32) - self.mean) / self.std


class CenterCrop:
    def __init__(self, size: Tuple[int, int] = (88, 88)):
        self.size = size

    def __call__(self, x: np.ndarray) -> np.ndarray:
        h, w = x.shape[-2:]
        ch, cw = self.size
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        return x[..., y0 : y0 + ch, x0 : x0 + cw]


class QuantizeUint8:
    """Cast raw-intensity video (values 0..255) to uint8 for the
    device-normalize inference path (4x less host->device transfer;
    ``Speech2Text.inputs`` dequantises on the device). No-op on uint8."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.dtype == np.uint8:
            return x
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)


class RandomCrop:
    def __init__(self, size: Tuple[int, int] = (88, 88), rng=None):
        self.size = size
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        h, w = x.shape[-2:]
        ch, cw = self.size
        y0 = self.rng.randint(0, h - ch + 1)
        x0 = self.rng.randint(0, w - cw + 1)
        return x[..., y0 : y0 + ch, x0 : x0 + cw]


class HorizontalFlip:
    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.rng.rand() < self.p:
            return x[..., ::-1].copy()
        return x


class TimeMasking:
    """Mask up to 0.4 s of frames per second with the mean frame."""

    def __init__(self, fps: int = FPS, max_mask_ratio_per_second: float = 0.4, rng=None):
        self.fps = fps
        self.max_ratio = max_mask_ratio_per_second
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = x.copy()
        seconds = max(1, x.shape[0] // self.fps)
        mean_frame = x.mean(axis=0)
        for _ in range(seconds):
            width = self.rng.randint(0, int(self.max_ratio * self.fps) + 1)
            if width == 0 or width >= x.shape[0]:
                continue
            start = self.rng.randint(0, x.shape[0] - width)
            x[start : start + width] = mean_frame
        return x


class VideoSpeedRate:
    """Frame-rate speed change by index resampling."""

    def __init__(self, rates=(0.9, 1.0, 1.1), rng=None):
        self.rates = list(rates)
        self.rng = rng or np.random.RandomState()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        rate = self.rates[self.rng.randint(len(self.rates))]
        if rate == 1.0:
            return x
        n_out = max(1, int(round(x.shape[0] / rate)))
        idx = np.clip(
            np.round(np.linspace(0, x.shape[0] - 1, n_out)).astype(int), 0, x.shape[0] - 1
        )
        return x[idx]
