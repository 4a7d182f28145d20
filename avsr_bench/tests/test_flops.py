"""The FLOP formula against ``FlopCounterMode`` over the reference at a tiny size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import check, drivers, flops, traffic
from harness import weights as W
from reference import model as R


@pytest.mark.parametrize("name", ["tailored_greedy_long", "asr_greedy_f32_long"])
def test_encode_flops_match_the_counter_over_the_reference(name):
    c = tiny.cell(name, batch=2, seconds=1.2, dtype="float32")
    cfg = drivers.model_config(c.config)
    ref = R.build(cfg, cfg["vocab"], device="cpu")
    ref.load_state_dict(W.seeded_state(W.template_of(R.build(cfg, cfg["vocab"])), 1, "cpu", torch.float32),
                        assign=True)
    batch = check.to_device(traffic.make_pool(1, c.traffic)[0], "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        enc, _ = ref.encode(*ref.inputs(batch))
        R.ctc_log_probs(ref, enc)
    t = c.traffic
    want = flops.encode_flops(cfg, t["batch"], int(t["buffer_s"] * 16000), int(t["buffer_s"] * 25))
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-9)
