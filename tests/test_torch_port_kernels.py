"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package's Pallas kernels, which run here in interpret mode.

On the CPU a kernel wrapper runs its plain version; the CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py``. Cases: K1 (in-kernel rel-pos flash attention) with T not
a multiple of the block, K2 (flash attention) with and without a bias,
fully masked query rows, K3 (fused cgMLP gate) with T not a multiple of 8.
Tolerance 1e-5 abs, f32: the online softmax and the tiled sums round in
another order than one softmax over the whole row.
"""

import numpy as np
import pytest
import torch

from tailored_avsr_tpu.ops.flash_attention import flash_attention as pallas_flash
from tailored_avsr_tpu.ops.flash_attention import flash_attention_relpos as pallas_relpos
from tailored_avsr_tpu.ops.fused_csgu import fused_csgu as pallas_csgu
from tailored_avsr_tpu_torch.ops import flash_attention as fa
from tailored_avsr_tpu_torch.ops import fused_csgu as fc

ATOL = 1e-5


def _attention_inputs(seed, b, h, t, dk, lengths):
    rs = np.random.RandomState(seed)
    q, k, v, qr = (rs.randn(b, h, t, dk).astype(np.float32) for _ in range(4))
    pos = rs.randn(h, 2 * t - 1, dk).astype(np.float32)
    bias = rs.randn(b, h, t, t).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, qr, pos, bias, mask


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_k1_relpos_plain_matches_pallas():
    q, k, v, qr, pos, _, mask = _attention_inputs(0, 2, 2, 50, 16, [50, 31])
    want = pallas_relpos(q, k, v, qr, pos, mask, block=16, interpret=True)
    got = fa.flash_attention_relpos(*_t(q, k, v, qr, pos, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_k2_plain_matches_pallas(with_bias):
    q, k, v, _, _, bias, mask = _attention_inputs(1, 2, 3, 45, 16, [45, 20])
    bias = bias if with_bias else None
    mask = mask if with_bias else None  # the no-bias case also takes no mask
    want = pallas_flash(q, k, v, bias, mask, block_q=16, block_k=16, interpret=True)
    got = fa.flash_attention(*_t(q, k, v), bias=None if bias is None else torch.from_numpy(bias),
                             mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fully_masked_utterance_gives_zeros():
    q, k, v, qr, pos, bias, mask = _attention_inputs(2, 2, 2, 20, 16, [20, 0])
    want = pallas_flash(q, k, v, bias, mask, block_q=16, block_k=16, interpret=True)
    got = fa.flash_attention(*_t(q, k, v, bias, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[1].any()
    want = pallas_relpos(q, k, v, qr, pos, mask, block=16, interpret=True)
    got = fa.flash_attention_relpos(*_t(q, k, v, qr, pos, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[1].any()


def test_k3_plain_matches_pallas():
    rs = np.random.RandomState(3)
    b, t, u, ks = 2, 13, 24, 7
    x = rs.randn(b, t, u).astype(np.float32)
    gamma = (1 + 0.1 * rs.randn(u // 2)).astype(np.float32)
    beta = (0.1 * rs.randn(u // 2)).astype(np.float32)
    w = rs.randn(ks, 1, u // 2).astype(np.float32)
    cb = (0.1 * rs.randn(u // 2)).astype(np.float32)
    want = pallas_csgu(x, gamma, beta, w, cb, interpret=True)
    got = fc.fused_csgu(*_t(x, gamma, beta, w, cb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrappers_are_forward_only_and_count_only_launches():
    """A tensor that autograd would track is refused (the kernels have no
    backward, like the Pallas kernels); CPU calls launch nothing."""
    q, k, v, qr, pos, bias, mask = _t(*_attention_inputs(4, 1, 1, 8, 16, [8]))
    before = (fa.flash_attention.launches, fa.flash_attention_relpos.launches, fc.fused_csgu.launches)
    with torch.no_grad():
        fa.flash_attention(q, k, v, bias, mask)
        fa.flash_attention_relpos(q, k, v, qr, pos, mask)
    assert (fa.flash_attention.launches, fa.flash_attention_relpos.launches,
            fc.fused_csgu.launches) == before
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention(q.requires_grad_(), k, v, bias, mask)
    x = torch.zeros(1, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.fused_csgu(x, torch.ones(4), torch.zeros(4), torch.zeros(3, 1, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="one device"):
        fc.fused_csgu(x.detach(), torch.ones(4, device="meta"), torch.zeros(4),
                      torch.zeros(3, 1, 4), torch.zeros(4))

