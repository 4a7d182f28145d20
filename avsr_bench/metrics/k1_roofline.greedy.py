"""K1's share of its roofline over the traced window (%): the sum of its
bound over its launches (``harness/flops.k1_cost`` at the cell's padded
shape, over the peak of the served type) divided by the device time of
the flash-attention kernels. Read only where K1 was the one flash
attention launched (K2 shares its kernels)."""

from harness import flops


def read(run):
    k1, k2 = run.launches.get("K1", 0), run.launches.get("K2", 0)
    seconds = run.trace.kernels_matching("flash_attention")
    if k1 == 0 or k2 != 0 or seconds <= 0:
        return None
    enc = run.cfg["encoder_conf"]
    h = enc["attention_heads"]
    cost = flops.k1_cost(run.batch, h, run.frames, enc["output_size"] // h, run.dtype)
    return 100.0 * k1 * flops.bound_s(cost, run.dtype) / seconds
