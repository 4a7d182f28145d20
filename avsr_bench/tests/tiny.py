"""Tiny cells for the CPU tests: each benchmark cell's configuration cut
to its family's tiny widths (``harness/families/<family>.tiny``), its LM
to two layers, its traffic to 3 utterances of 1.5 s."""

import copy

from harness import families, manifest

TINY_LM = {"att_unit": 32, "unit": 48, "layer": 2, "head": 4, "embed_unit": 16}


def cut(c: manifest.Cell, batch: int = 3, seconds: float = 1.5, dtype: str = None) -> manifest.Cell:
    c = copy.deepcopy(c)
    c.config["model"] = families.load(c.config["family"]).tiny(c.config["model"])
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
