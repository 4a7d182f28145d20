"""Split-CSV dataset of ASR / VSR / AVSR samples
(counterpart of ``tailored_avsr_tpu/data/dataset.py``), read with the
standard ``csv`` module.

CSV columns ``database,sampleID,nframes,wav_path,lips_path,transcription_path,...``
(``splits/*.csv``); audio from WAV normalised to [-1, 1] (scipy); video
from ``.npz['data']`` (T, 96, 96), VLRF decimated 50 -> 25 fps by ``[::2]``;
transcriptions upper-cased with '{' and '}' stripped; the training split
keeps ``nframes <= nframes_limit``.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np


def load_wav(path: str) -> np.ndarray:
    """A WAV file's first channel as float32 in [-1, 1]."""
    from scipy.io import wavfile

    _, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data[:, 0]
    return data


class AVSRDataset:
    def __init__(
        self,
        dataset_path: str,
        task: str = "avsr",
        nframes_limit: Optional[int] = None,
        is_training: bool = True,
    ):
        self.task = task
        with open(dataset_path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f, delimiter=","))
        if is_training and nframes_limit is not None:
            rows = [r for r in rows if int(r["nframes"]) <= nframes_limit]
        self.samples = rows

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        row = self.samples[index]
        sample = {"sample_id": row["sampleID"]}
        if self.task in ("asr", "avsr"):
            sample["audio"] = load_wav(row["wav_path"])
        if self.task in ("vsr", "avsr"):
            lips = np.load(row["lips_path"])["data"]
            if row["database"].lower() == "vlrf":  # 50 fps -> 25 fps
                lips = lips[::2]
            sample["video"] = lips
        with open(row["transcription_path"], "r", encoding="utf-8") as f:
            text = f.readlines()[0].strip()
        sample["transcription"] = text.upper().replace("{", "").replace("}", "")
        return sample
