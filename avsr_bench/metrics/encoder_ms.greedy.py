"""Device ms a greedy request spends in the encoder's layers, its final
norm and (audio-visual) the adaptive fusion (``models/tailored.py``,
``models/branchformer.py``, ``ops/attention.py``, ``ops/cgmlp.py``,
``models/fusion.py``)."""

SPANS = {"encoder": ["encoder.encoders.[0-9]", "encoder.encoders.[0-9][0-9]", "encoder.after_norm",
                     "audiovisual_fusion"]}


def read(run):
    return run.trace.span_ms_per_call("encoder")
