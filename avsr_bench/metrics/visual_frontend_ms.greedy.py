"""Device ms a greedy request spends under the visual frontend
(``models/frontends.py``: the Conv3D stem and the ResNet-18 trunk)."""

SPANS = {"visual_frontend": ["visual_frontend"]}


def read(run):
    return run.trace.span_ms_per_call("visual_frontend")
