"""Batching and collation with bucketed padding and background prefetch
(counterpart of ``tailored_avsr_tpu/data/dataloader.py``).

Per-task batch dicts ('speech/...' for asr and vsr, 'audio/video/...' for
avsr); audio truncated to a multiple of 640 samples (16000 / 25, so the
audio's STFT frames and the 25 fps video reach equal lengths after the x4
subsampling); features and text padded with ignore_id (-1), uint8 video
with 0. Padded buffer lengths are rounded up to bucket multiples
(``round_up``), so a run sees few distinct shapes; a background thread
prefetches the next batch while the device computes, and with ``workers``
> 1 a thread pool reads the samples while transforms and collation stay on
that one thread (the batches do not depend on ``workers``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

AUDIO_CHUNK = 640  # samples per video frame at 16 kHz / 25 fps


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def pad_batch(arrays: List[np.ndarray], pad_value: float, target_len: int) -> np.ndarray:
    """Stack variable-length arrays into (B, target_len, ...) with pad_value."""
    shape = (len(arrays), target_len) + arrays[0].shape[1:]
    out = np.full(shape, pad_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


class AVSRDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        task: str = "avsr",
        audio_transforms: Optional[Callable] = None,
        video_transforms: Optional[Callable] = None,
        tokenizer=None,
        converter=None,
        ignore_id: int = -1,
        is_training: bool = True,
        seed: int = 0,
        bucket_audio: int = AUDIO_CHUNK * 8,  # pad audio samples to this multiple
        bucket_frames: int = 8,  # pad video frames to this multiple
        bucket_text: int = 8,
        prefetch: int = 2,
        drop_last: bool = False,
        workers: int = 0,  # >1: parallel sample reads (IO, npz decode) with
        #   batch read-ahead (training_settings num_workers). Transforms stay
        #   on the single producer thread, so the augmentation RNG's draw
        #   order, and every batch, equal the serial loader's.
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.task = task
        self.audio_transforms = audio_transforms
        self.video_transforms = video_transforms
        self.tokenizer = tokenizer
        self.converter = converter
        self.ignore_id = ignore_id
        self.is_training = is_training
        self.rng = np.random.RandomState(seed)
        self.bucket_audio = bucket_audio
        self.bucket_frames = bucket_frames
        self.bucket_text = bucket_text
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.workers = int(workers)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _collate(self, samples: List[Dict]) -> Dict:
        batch: Dict = {
            "sample_id": [s["sample_id"] for s in samples],
            "refs": [s["transcription"] for s in samples],
        }
        texts = []
        for s in samples:
            toks = self.tokenizer.text2tokens(s["transcription"])
            texts.append(np.asarray(self.converter.tokens2ids(toks), np.int32))
        tmax = round_up(max(t.shape[0] for t in texts), self.bucket_text)
        batch["text"] = pad_batch(texts, self.ignore_id, tmax)
        batch["text_lengths"] = np.asarray([t.shape[0] for t in texts], np.int32)

        def audio_feats():
            auds = []
            for s in samples:
                a = s["audio"]
                if self.audio_transforms is not None:
                    a = self.audio_transforms(a)
                a = a[: len(a) // AUDIO_CHUNK * AUDIO_CHUNK].astype(np.float32)
                auds.append(a)
            amax = round_up(max(len(a) for a in auds), self.bucket_audio)
            return (
                pad_batch(auds, float(self.ignore_id), amax),
                np.asarray([len(a) for a in auds], np.int32),
            )

        def video_feats():
            vids = []
            for s in samples:
                v = s["video"]
                if self.video_transforms is not None:
                    v = self.video_transforms(v)
                # uint8 passes through untouched (dequantised on the device:
                # 4x less host->device transfer; Speech2Text.inputs)
                vids.append(v if v.dtype == np.uint8 else v.astype(np.float32))
            vmax = round_up(max(v.shape[0] for v in vids), self.bucket_frames)
            pad = 0.0 if vids[0].dtype == np.uint8 else float(self.ignore_id)
            return (
                pad_batch(vids, pad, vmax),
                np.asarray([v.shape[0] for v in vids], np.int32),
            )

        if self.task == "asr":
            batch["speech"], batch["speech_lengths"] = audio_feats()
        elif self.task == "vsr":
            batch["speech"], batch["speech_lengths"] = video_feats()
        elif self.task == "avsr":
            batch["audio"], batch["audio_lengths"] = audio_feats()
            batch["video"], batch["video_lengths"] = video_feats()
        else:
            raise ValueError(self.task)
        return batch

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.is_training:
            self.rng.shuffle(idx)
        batches = [
            list(idx[i : i + self.batch_size])
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer abandoned the
            # iterator (otherwise the thread blocks forever on a full queue)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if self.workers > 1:
                    # parallel reads (numpy/zlib release the GIL), serial
                    # transforms+collate: deterministic and IO-overlapped
                    from collections import deque
                    from concurrent.futures import ThreadPoolExecutor

                    ex = ThreadPoolExecutor(max_workers=self.workers)
                    try:
                        it = iter(batches)
                        pending: deque = deque()

                        def submit_next():
                            b = next(it, None)
                            if b is not None:
                                pending.append(
                                    [ex.submit(self.dataset.__getitem__, i)
                                     for i in b]
                                )

                        for _ in range(max(2, self.prefetch)):
                            submit_next()
                        while pending:
                            samples = [f.result() for f in pending.popleft()]
                            submit_next()
                            if not put(self._collate(samples)):
                                return
                    finally:
                        ex.shutdown(wait=False, cancel_futures=True)
                else:
                    for b in batches:
                        if not put(self._collate([self.dataset[i] for i in b])):
                            return
            except BaseException as e:  # propagate to the consumer
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # release a producer blocked on a full queue
