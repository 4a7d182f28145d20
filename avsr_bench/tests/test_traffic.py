"""The traffic pools: the same seed, the same inputs; every seed, the same work."""

import numpy as np

from harness import manifest, traffic

BIG = 2 ** 31 + 12345


def _traffic(name, **kw):
    t = dict(manifest.loose_cell("tailored_avsr_es_bf16", name).traffic, **kw)
    return t


def test_same_seed_same_pool():
    t = _traffic("long_24x20s", batch=4, buffer_s=1.0)
    a, b = traffic.make_pool(BIG, t), traffic.make_pool(BIG, t)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def test_seeds_differ_in_samples_not_in_work():
    t = _traffic("long_24x20s", batch=6, buffer_s=1.0)
    a, b = traffic.make_pool(1, t), traffic.make_pool(BIG, t)
    assert not np.array_equal(a[0]["audio"], b[0]["audio"])
    for x, y in zip(a, b):
        assert traffic.speech_seconds(x) == traffic.speech_seconds(y)
        assert sorted(x["video_lengths"]) == sorted(y["video_lengths"])


def test_consecutive_batches_differ_and_the_longest_fills_the_buffer():
    t = _traffic("long_24x20s", batch=5, buffer_s=1.0)
    pool = traffic.make_pool(7, t)
    assert len(pool) >= 2 and not np.array_equal(pool[0]["audio"], pool[1]["audio"])
    for b in pool:
        assert b["audio_lengths"].max() == 16000 and b["video_lengths"].max() == 25
        assert b["audio_lengths"].min() == int(0.6 * 16000)
        assert b["audio"].dtype == np.int16 and b["video"].dtype == np.uint8


def test_audio_only_mix_sends_speech():
    t = dict(manifest.loose_cell("branchformer_asr_es_f32", "asr_long_64x20s").traffic, batch=3, buffer_s=1.0)
    b = traffic.make_pool(3, t)[0]
    assert set(b) == {"speech", "speech_lengths"} and traffic.utterances(b) == 3
