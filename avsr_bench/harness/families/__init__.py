"""Model families, one module a family: ``harness/families/<family>.py``,
found by the configuration file's top-level ``family`` key (``load``). A
family module is the glue between the harness and the family's plain
model (``reference/<family>.py``), and provides:

- ``build(cfg, vocab, device="meta")``: the reference model of ``cfg`` (a
  configuration's ``model`` with ``vocab``) in eval mode. Its state dict is
  the template of the seeded weights, so its key order is the order of
  the draw (``weights.seeded_state``);
- ``ROWS``: the utterances a block of the reference encodes at once;
- ``encoder_frames(cfg, samples, frames)``: the encoder's padded length
  for a buffer of ``samples`` and ``frames``;
- ``encode_flops(cfg, b, samples, frames)``: the FLOPs of one encode, from
  ``flops.py``'s counts;
- ``tiny(model)``: the configuration's ``model`` cut to the widths of the
  CPU tests;
- optionally ``LAUNCH_COUNTERS``: further launch counters of the program,
  name -> ``"module:attribute"`` (``drivers.kernel_counters``).

Where a family defines none of its own, ``load`` gives it the shared glue
below: ``build_lm``, ``encode_rows`` and ``ctc_log_probs`` of
``reference/model.py``, and ``call_flops(cfg, traffic)``, the FLOPs of one
call (``mfu`` reads it). A family whose search the entry's
``search_flops`` does not count, such as Mask-CTC's MLM rounds under
``nbest``, defines its own ``call_flops``.
"""

from __future__ import annotations

import functools
import types
from typing import Dict

from reference.model import build_lm, ctc_log_probs, encode_rows

from .. import manifest
from .. import traffic as tf


def call_flops(family, cfg: Dict, traffic: Dict) -> float:
    """FLOPs of one call of the traffic's entry: the family's encode of the
    mix's buffer and what the entry's search adds over the encoder's
    output (its driver's ``search_flops``; the beam's steps are the
    ``mfu.beam`` reader's, by the steps each call ran)."""
    b, (samples, frames) = int(traffic["batch"]), tf.buffer(traffic)
    search = manifest.module("entries", traffic["entry"]).Driver.search_flops
    return family.encode_flops(cfg, b, samples, frames) + search(cfg, b, family.encoder_frames(cfg, samples, frames))


def load(name: str) -> types.SimpleNamespace:
    """The family ``name``: its module's names over the shared glue."""
    module = manifest.module("families", name)
    family = types.SimpleNamespace(build_lm=build_lm, encode_rows=encode_rows, ctc_log_probs=ctc_log_probs)
    family.call_flops = functools.partial(call_flops, family)
    vars(family).update(vars(module))
    return family
