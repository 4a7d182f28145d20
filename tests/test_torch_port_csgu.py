"""The redesigned fused cgMLP gate (K3) on the CPU: its decomposition and
the checks of its wrapper.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to
``fused_csgu_plain`` there over an edge sweep of T, k and B). What is checked
here is the arithmetic of its decomposition: a PyTorch emulation, written in
this file, of what ``csrc/csgu.cu`` computes, tile by tile:
- a cluster of blocks serves one ``TIME_TILE``-row tile of one batch row,
  staging the tile's x_g rows with (k-1)/2 halo rows on each side and its
  x_r rows; rows outside [0, T) are zero and marked invalid;
- block q of the cluster owns ``channel_tile`` channels. Each lane of a warp
  sums its 8 channels in order, the warp adds the lanes by a butterfly, and
  the block keeps its partial (mean, M2) per row (M2 by a second pass over
  the same values);
- the cluster's partials are combined in rank order by Chan's parallel
  variance into each row's mean and 1/std;
- each channel walks down the staged rows once: a row's normalised value
  feeds every output accumulator it touches (the register window), and the
  output is x_r times the accumulator.
The emulation runs at a narrow C split over three blocks (the last one
short) to exercise the cluster's combine, against the JAX package's Pallas
K3 in interpret mode, f32, tolerance 1e-5 (sums in another order). It is
not the kernel: it shows that the decomposition is exact, not that the
CUDA code computes it.
"""

import numpy as np
import pytest
import torch

from tailored_avsr_tpu.ops.fused_csgu import fused_csgu as pallas_csgu
from tailored_avsr_tpu_torch.ops import fused_csgu as fc

ATOL = 1e-5


def _butterfly(lanes: torch.Tensor) -> torch.Tensor:
    """A warp's xor-shuffle sum over its 32 lanes (the last axis), as
    ``warp_sum`` adds them; lane 0's total."""
    v = torch.nn.functional.pad(lanes, (0, 32 - lanes.shape[-1]))
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ off]
    return v[..., 0]


def _csgu_by_tiles(x, gamma, beta, w, cb, channel_tile=fc.CHANNEL_TILE):
    """K3's decomposition in f32: (B, T, 2C) -> (B, T, C)."""
    b, t, u = x.shape
    c, k = u // 2, w.shape[0]
    half, tile = (k - 1) // 2, fc.TIME_TILE
    rows, n_rank = tile + k - 1, -(-c // channel_tile)
    out = torch.full((b, t, c), float("nan"))
    for bi in range(b):
        for t0 in range(0, t, tile):
            tt = min(tile, t - t0)
            ts = torch.arange(t0 - half, t0 - half + rows)
            valid = (ts >= 0) & (ts < t)
            staged = torch.zeros(rows, n_rank * channel_tile)
            staged[valid, :c] = x[bi, ts[valid], c:]
            parts = []
            for q in range(n_rank):
                n_b = min(channel_tile, c - q * channel_tile)
                lanes = staged[:, q * channel_tile:(q + 1) * channel_tile].reshape(rows, -1, 8)
                mine = (q * channel_tile + 8 * torch.arange(lanes.shape[1]) < c).float()
                s = torch.zeros(rows, lanes.shape[1])
                for e in range(8):
                    s = s + lanes[..., e]
                mean_b = _butterfly(s * mine) / n_b
                sq = torch.zeros_like(s)
                for e in range(8):
                    sq = (lanes[..., e] - mean_b[:, None]) ** 2 + sq
                parts.append((n_b, mean_b, _butterfly(sq * mine)))
            mean = torch.zeros(rows)
            for n_b, mean_b, _ in parts:
                mean = n_b * mean_b + mean
            mean = mean / c
            m2 = torch.zeros(rows)
            for n_b, mean_b, m2_b in parts:
                d = mean_b - mean
                m2 = m2 + (n_b * d * d + m2_b)
            rstd = torch.rsqrt(m2 / c + fc.LN_EPS)
            ln = ((staged[:, :c] - mean[:, None]) * rstd[:, None] * gamma + beta) * valid[:, None]
            acc = cb.expand(tt, c).clone()
            for r in range(tt + k - 1):  # row r feeds outputs i = r - j, j < k
                i = torch.arange(max(0, r - k + 1), min(tt - 1, r) + 1)
                acc[i] = w[r - i, 0] * ln[r] + acc[i]
            out[bi, t0:t0 + tt] = x[bi, t0:t0 + tt, :c] * acc
    return out


@pytest.mark.parametrize("k", [3, 31])
@pytest.mark.parametrize("t", [1, 2, 15, 16, 17, "k-1", 100])
def test_csgu_tiles_match_pallas(t, k):
    """Time tiles (T across the 32-row tile and short of the halo), halo rows,
    the cluster's statistics (C = 40 over blocks of 16, 16 and 8 channels)
    and the register window against the Pallas K3 in interpret mode."""
    t = k - 1 if t == "k-1" else t
    rs = np.random.RandomState(10 * t + k)
    b, c = 2, 40
    x = (rs.randn(b, t, 2 * c) + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    beta = (0.1 * rs.randn(c)).astype(np.float32)
    w = (rs.randn(k, 1, c) / np.sqrt(k)).astype(np.float32)
    cb = (0.1 * rs.randn(c)).astype(np.float32)
    want = np.asarray(pallas_csgu(x, gamma, beta, w, cb, interpret=True))
    got = _csgu_by_tiles(*(torch.from_numpy(a) for a in (x, gamma, beta, w, cb)), channel_tile=16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _csgu_inputs(b=2, t=5, c=1024, k=31, dtype=torch.bfloat16):
    return (torch.zeros(b, t, 2 * c, dtype=dtype), torch.ones(c, dtype=dtype), torch.zeros(c, dtype=dtype),
            torch.zeros(k, 1, c, dtype=dtype), torch.zeros(c, dtype=dtype))


def test_csgu_checks_refuse_what_the_kernel_does_not_take():
    """The flagship's shapes pass in both types; a gate width that is no
    multiple of 8 or above 2048 (a cluster of more than 8 blocks), an even
    kernel size or one above 127 (an f32 block's staged rows would not fit
    its shared memory), another type, a misaligned x and a parameter of
    another shape raise."""
    for dtype in (torch.float32, torch.bfloat16):
        fc.check_inputs(*_csgu_inputs(dtype=dtype))
        fc.check_inputs(*_csgu_inputs(c=8, k=127, dtype=dtype))
        fc.check_inputs(*_csgu_inputs(c=2048, k=3, dtype=dtype))
    for kwargs in ({"c": 1020}, {"c": 12}, {"c": 2056}, {"k": 30}, {"k": 129}):
        with pytest.raises(ValueError):
            fc.check_inputs(*_csgu_inputs(**kwargs))
    with pytest.raises(TypeError):
        fc.check_inputs(*_csgu_inputs(dtype=torch.float16))
    x, *params = _csgu_inputs()
    off = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    assert off.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        fc.check_inputs(off, *params)
    with pytest.raises(ValueError, match="conv_w"):
        fc.check_inputs(x, *params[:2], params[2][:, :, :512], params[3])


def test_chip_smokes_phase_cuts_still_apply_to_the_source():
    """``chip_smoke.py --k3-phases`` times copies of ``csrc/csgu.cu`` with
    its phases edited out; every edit must still find its text."""
    from chip_smoke import K3_PHASE_CUTS
    from tailored_avsr_tpu_torch.kernels import build

    src = (build.CSRC / "csgu.cu").read_text()
    for _, cuts in K3_PHASE_CUTS:
        for old, new in cuts:
            assert old in src, old
            src = src.replace(old, new)
