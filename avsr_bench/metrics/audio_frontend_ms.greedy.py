"""Device ms a greedy request spends in the audio frontend: log-mel
(``ops/frontend_audio.py``), utterance MVN (``ops/normalize.py``) and the
conv2d subsampling (``ops/subsampling.py``)."""

SPANS = {"audio_frontend": ["acoustic_frontend", "frontend", "normalize", "acoustic_embed.embed", "encoder.embed"]}


def read(run):
    return run.trace.span_ms_per_call("audio_frontend")
