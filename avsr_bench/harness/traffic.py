"""The one traffic generator: a pool of distinct batches, made from the
seed in set-up, that the window cycles through (a closed loop: one
client sends the next batch once the previous call has returned).

A traffic file gives the entry (``greedy``, ``nbest`` or ``train``), the
batch, the buffer in seconds, the streams (``audio``, ``video``), the
range of utterance lengths as shares of the buffer and the pool's size.
Every seed gets
the same multiset of lengths (an even grid over the range, the longest
filling the buffer) in another order, so the seed changes which samples
are sent and not how much work they are.

Requests are what a client of ``Speech2Text`` sends with
``device_normalize``: int16 audio at 16 kHz and uint8 88x88 lip crops at
25 fps. Both move as speech and lips do, segment by segment: the audio
in 50-250 ms segments, each a tone (80-3,500 Hz) mixed with noise at its
own level (0 to -30 dB); the video in segments of 2-8 frames, each the
crop's noise at its own brightness and contrast. (Stationary white noise
gives every frame the same features, and the models' outputs then carry
one token an utterance, which no check can tell from another.)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

SAMPLE_RATE = 16000
FPS = 25
CROP = 88


def length_grid(batch: int, lo: float, hi: float) -> np.ndarray:
    """``batch`` shares of the buffer, evenly from ``lo`` to ``hi``."""
    return np.linspace(hi, lo, batch) if batch > 1 else np.array([hi])


def _segments(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """Segment ids over ``n`` steps, each segment ``lo``..``hi`` steps long."""
    lens = rng.integers(lo, hi + 1, n // lo + 2)
    return np.repeat(np.arange(len(lens)), lens)[:n]


def speech_like_audio(rng: np.random.Generator, b: int, samples: int) -> np.ndarray:
    """One stream of segments cut into ``b`` utterances of ``samples``."""
    n = b * samples
    seg = _segments(rng, n, SAMPLE_RATE // 20, SAMPLE_RATE // 4)
    k = int(seg[-1]) + 1
    gain = (8000.0 * 10.0 ** (rng.uniform(-30.0, 0.0, k) / 20.0)).astype(np.float32)[seg]
    step = (2.0 * np.pi / SAMPLE_RATE * rng.uniform(80.0, 3500.0, k))[seg]
    tone = rng.uniform(0.0, 1.0, k).astype(np.float32)[seg]
    phase = np.mod(np.cumsum(step), 2.0 * np.pi).astype(np.float32)
    wave = gain * (1.4 * tone * np.sin(phase) + (1.0 - tone) * rng.standard_normal(n, dtype=np.float32))
    return np.clip(wave, -32768, 32767).astype(np.int16).reshape(b, samples)


def moving_video(rng: np.random.Generator, b: int, frames: int) -> np.ndarray:
    """Noise in 2 x 2 pixel blocks, each frame at its segment's brightness and contrast."""
    half = CROP // 2
    noise = rng.integers(0, 256, (b, frames, half, half), dtype=np.uint8)
    levels = np.arange(256, dtype=np.float32) - 128.0
    out = np.empty((b, frames, CROP, CROP), np.uint8)
    for i in range(b):
        seg = _segments(rng, frames, 2, 8)
        k = int(seg[-1]) + 1
        bright, contrast = rng.uniform(30.0, 220.0, k)[seg], rng.uniform(0.1, 0.9, k)[seg]
        lut = np.clip(levels[None] * contrast[:, None] + bright[:, None], 0, 255).astype(np.uint8)  # (frames, 256)
        small = lut[np.arange(frames)[:, None, None], noise[i]]
        out[i] = small.repeat(2, axis=1).repeat(2, axis=2)
    return out


def buffer(traffic: Dict) -> Tuple[int, int]:
    """(audio samples, video frames) of the buffer every utterance is padded to."""
    sec = float(traffic["buffer_s"])
    return int(sec * SAMPLE_RATE), int(sec * FPS)


def make_batch(rng: np.random.Generator, traffic: Dict) -> Dict[str, np.ndarray]:
    b = int(traffic["batch"])
    lo, hi = traffic["length_share"]
    frac = rng.permutation(length_grid(b, lo, hi))
    samples, frames = buffer(traffic)
    streams = traffic["streams"]
    out: Dict[str, np.ndarray] = {}
    audio_key = "audio" if "video" in streams else "speech"
    if "audio" in streams:
        out[audio_key] = speech_like_audio(rng, b, samples)
        out[audio_key + "_lengths"] = (frac * samples).astype(np.int32)
    if "video" in streams:
        out["video"] = moving_video(rng, b, frames)
        out["video_lengths"] = np.ceil(frac * frames).astype(np.int32)
    return out


def make_pool(seed: int, traffic: Dict) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` distinct batches from ``seed``."""
    rng = np.random.default_rng(int(seed))
    return [make_batch(rng, traffic) for _ in range(int(traffic["pool"]))]


def speech_seconds(batch: Dict[str, np.ndarray]) -> float:
    """Seconds of speech a batch holds: its audio samples at 16 kHz."""
    key = "audio_lengths" if "audio_lengths" in batch else "speech_lengths"
    return float(np.sum(batch[key], dtype=np.int64)) / SAMPLE_RATE


def utterances(batch: Dict[str, np.ndarray]) -> int:
    return len(batch["audio_lengths" if "audio_lengths" in batch else "speech_lengths"])
