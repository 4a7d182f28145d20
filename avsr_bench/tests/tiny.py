"""Tiny cells for the CPU tests: each benchmark cell's configuration cut
to the widths of ``configs/tests/avsr_tiny.yaml``, its traffic to 3
utterances of 1.5 s."""

import copy
import os

import yaml

from harness import manifest

ROOT = manifest.ROOT
TINY_LM = {"att_unit": 32, "unit": 48, "layer": 2, "head": 4, "embed_unit": 16}
TINY_ENCODER = {"output_size": 32, "linear_units": 48, "cgmlp_linear_units": 48, "cgmlp_conv_kernel": 7,
                "num_blocks": 2}


def cut(c: manifest.Cell, batch: int = 3, seconds: float = 1.5, dtype: str = None) -> manifest.Cell:
    c = copy.deepcopy(c)
    model = c.config["model"]
    if model["task"] == "avsr":
        with open(os.path.join(ROOT, "configs/tests/avsr_tiny.yaml"), encoding="utf-8") as f:
            tiny = yaml.safe_load(f)
        tiny["token_list"] = model["token_list"]
        tiny["dtype"] = model["dtype"]
        tiny["inference_conf"] = dict(model["inference_conf"])
        c.config["model"] = tiny
    else:
        model["encoder_conf"].update(TINY_ENCODER)
        model["decoder_conf"].update(linear_units=48, num_blocks=1)
    if dtype is not None:
        c.config["model"]["dtype"] = dtype
    if "lm" in c.config:
        c.config["lm"]["lm_conf"] = dict(c.config["lm"]["lm_conf"], **TINY_LM)
    c.traffic = dict(c.traffic, batch=batch, buffer_s=seconds)
    return c


def cell(name: str, **kw) -> manifest.Cell:
    return cut(manifest.cell(name), **kw)


def loose(config: str, traffic: str, **kw) -> manifest.Cell:
    return cut(manifest.loose_cell(config, traffic), **kw)
