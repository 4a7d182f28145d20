"""Each family's FLOP formula against ``FlopCounterMode`` over its reference at a tiny size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import check, drivers, families, traffic
from harness import weights as W


@pytest.mark.parametrize("name", ["tailored_greedy_long", "asr_greedy_f32_long"])
def test_encode_flops_match_the_counter_over_the_reference(name):
    c = tiny.cell(name, batch=2, seconds=1.2, dtype="float32")
    family = families.load(c.config["family"])
    cfg = drivers.model_config(c.config)
    ref = family.build(cfg, cfg["vocab"], device="cpu")
    ref.load_state_dict(W.seeded_state(W.template_of(family.build(cfg, cfg["vocab"])), 1, "cpu", torch.float32),
                        assign=True)
    batch = check.to_device(traffic.make_pool(1, c.traffic)[0], "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        enc, _ = family.encode_rows(ref, batch, range(2))
        family.ctc_log_probs(ref, enc)
    want = family.call_flops(cfg, c.traffic)
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-9)
