"""Rates, tails, spreads and roofline bounds."""

import statistics

import pytest

from harness import flops, stats


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(384.0, 0.2) == pytest.approx(1920.0)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_percentile_interpolates_like_numpy():
    xs = [float(x) for x in range(1, 101)]
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_bound_is_the_longer_of_bytes_and_operations():
    c = {"flops": 989e12, "bytes": 3.35e12 / 2}
    assert flops.bound_s(c, "bfloat16") == pytest.approx(1.0)
    assert flops.bound_s(c, "float32") == pytest.approx(989 / 67)
    assert flops.bound_s({"flops": 0.0, "bytes": 3.35e12}, "float32") == pytest.approx(1.0)


def test_k1_cost_counts_three_t_by_t_products_and_each_byte_once():
    c = flops.k1_cost(24, 4, 500, 64, "bfloat16")
    assert c["flops"] == 6 * 24 * 4 * 500 * 500 * 64
    assert c["bytes"] == 4 * 24 * 4 * 500 * 64 * 2 + 4 * 999 * 64 * 2 + 2 * 4 * 64 * 2 + 24 * 500
    # f32 K1 at B=24 T=500: PERF.md's kernel table gives 0.1376 ms, by operations
    assert flops.bound_s(flops.k1_cost(24, 4, 500, 64, "float32"), "float32") == pytest.approx(0.1376e-3, rel=1e-3)


def test_k4_bound_grows_with_the_position():
    cfg = {"encoder_conf": {"output_size": 256}, "decoder_conf": {"attention_heads": 4, "linear_units": 2048,
                                                                   "num_blocks": 6},
           "inference_conf": {"beam_size": 10, "lm_weight": 0.4}, "vocab": 37}
    lm = {"lm_conf": {"att_unit": 512, "head": 8, "unit": 2048, "layer": 16, "embed_unit": 128}}
    assert flops.k4_step_bound_s(cfg, lm, 32, 1, "bfloat16") < flops.k4_step_bound_s(cfg, lm, 32, 50, "bfloat16")
    assert flops.beam_step_flops(cfg, lm, 32, 100, 2) < flops.beam_step_flops(cfg, lm, 32, 100, 3)
