"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package's Pallas kernels, which run here in interpret mode.

On the CPU a kernel wrapper runs its plain version; the CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py``. Cases: K1 (in-kernel rel-pos flash attention) with T not
a multiple of the block, K2 (flash attention) with and without a bias,
fully masked query rows, K3 (fused cgMLP gate) with T not a multiple of 8,
K4 (ancestry group attend) at every position of a small cache, at pos 1 and
with a narrowed width, K5 / K5' (cache column writes) at every column and
past the last (the clamp). Tolerance 1e-5 abs, f32: the online softmax and
the tiled sums round in another order than one softmax over the whole row;
the cache writes are bit-exact.
"""

import numpy as np
import pytest
import torch

from tailored_avsr_tpu.ops.flash_attention import flash_attention as pallas_flash
from tailored_avsr_tpu.ops.flash_attention import flash_attention_relpos as pallas_relpos
from tailored_avsr_tpu.ops.cache_update import write_cache_column as pallas_write
from tailored_avsr_tpu.ops.cache_update import write_cache_columns_kv as pallas_write_kv
from tailored_avsr_tpu.ops.fused_csgu import fused_csgu as pallas_csgu
from tailored_avsr_tpu.ops.group_attend import group_attend_anc as pallas_group_attend
from tailored_avsr_tpu_torch.ops import cache_update as cu
from tailored_avsr_tpu_torch.ops import flash_attention as fa
from tailored_avsr_tpu_torch.ops import fused_csgu as fc
from tailored_avsr_tpu_torch.ops import group_attend as ga

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


def _group_inputs(seed, b=2, h=2, km=3, lc=16, dk=8):
    rs = np.random.RandomState(seed)
    k, v = (rs.randn(b, h, km, lc, dk).astype(np.float32) for _ in range(2))
    q, k_new, v_new = (rs.randn(b, h, km, dk).astype(np.float32) for _ in range(3))
    anc = rs.randint(0, km, (b, km, lc)).astype(np.int32)
    anc[0, 1, 5:] = -1  # entries outside [0, K) match no slot
    return k, v, q, k_new, v_new, anc


@pytest.mark.parametrize("width", [None, 8])
def test_k4_plain_matches_pallas_over_every_pos(width):
    k, v, q, k_new, v_new, anc = _group_inputs(5)
    for pos in range(1, 18 if width is None else 10):
        want = pallas_group_attend(k, v, q, k_new, v_new, anc, pos, width=width, interpret=True)
        got = ga.group_attend_anc(*_t(k, v, q, k_new, v_new, anc), pos, width=width)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"pos {pos}")
    got = ga.group_attend_anc(*_t(k, v, q, k_new, v_new, anc), 1, width=width)
    assert torch.equal(got, torch.from_numpy(v_new))  # pos 1: only the step's own column
    with pytest.raises(ValueError, match="multiple of 8"):
        ga.group_attend_anc(*_t(k, v, q, k_new, v_new, anc), 3, width=12)


def test_k4_plain_matches_the_jax_xla_formulation():
    """Against ``attend_kv_anc(fused=False)`` with an identity output
    projection, in the (N, H, 1, dk) row layout the attention module uses."""
    import jax.numpy as jnp

    from tailored_avsr_tpu.ops.attention import MultiHeadedAttention

    b, h, km, lc, dk = 2, 2, 3, 16, 8
    k, v, q, k_new, v_new, anc = _group_inputs(6, b, h, km, lc, dk)
    mha = MultiHeadedAttention(h, 0.0, h * dk)
    eye = {"linear_out": {"kernel": jnp.eye(h * dk), "bias": jnp.zeros(h * dk)}}

    def rows(x):  # (B, H, K, dk) -> (N, H, 1, dk)
        return x.transpose(0, 2, 1, 3).reshape(b * km, h, 1, dk)

    for pos in (1, 2, 9, 17):
        want = mha.apply({"params": eye}, k, v, rows(k_new), rows(v_new), anc.reshape(b * km, lc),
                         pos, km, rows(q), None, False, method="attend_kv_anc")
        got = ga.group_attend_anc(*_t(k, v, q, k_new, v_new, anc), pos)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3).reshape(b * km, 1, h * dk),
                                   np.asarray(want), atol=ATOL, err_msg=f"pos {pos}")


def test_k5_plain_matches_pallas_bit_exact():
    rs = np.random.RandomState(7)
    b, h, km, lc, dk = 2, 2, 3, 16, 8
    kc, vc = (rs.randn(b, h, km, lc, dk).astype(np.float32) for _ in range(2))
    kcol, vcol = (rs.randn(b, h, km, dk).astype(np.float32) for _ in range(2))
    for pos in range(lc + 2):  # past the last column: the clamp
        wk, wv = pallas_write_kv(kc, vc, kcol, vcol, pos, interpret=True)
        gk, gv = cu.write_cache_columns_kv(*_t(kc.copy(), vc.copy(), kcol, vcol), pos)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk), err_msg=f"pos {pos}")
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv), err_msg=f"pos {pos}")
        w1 = pallas_write(kc, kcol, pos, interpret=True)
        g1 = cu.write_cache_column(torch.from_numpy(kc.copy()), torch.from_numpy(kcol), pos)
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1), err_msg=f"pos {pos}")


def test_k5_writes_in_place_and_rounds_to_the_cache_dtype():
    cache = torch.zeros(1, 1, 2, 8, 4, dtype=torch.bfloat16)
    col = torch.randn(1, 1, 2, 4, generator=torch.Generator().manual_seed(0))
    out = cu.write_cache_column(cache, col, 3)
    assert out is cache
    assert torch.equal(cache[:, :, :, 3], col.to(torch.bfloat16))
    assert not cache[:, :, :, :3].any() and not cache[:, :, :, 4:].any()
    with pytest.raises(ValueError, match=">= 0"):
        cu.write_cache_column(cache, col, -1)


def test_wrappers_are_forward_only_and_count_only_launches():
    """A tensor that autograd would track is refused (the kernels have no
    backward, like the Pallas kernels); CPU calls launch nothing."""
    q, k, v, qr, pos, bias, mask = _t(*_attention_inputs(4, 1, 1, 8, 16, [8]))
    wrappers = (fa.flash_attention, fa.flash_attention_relpos, fc.fused_csgu, ga.group_attend_anc,
                cu.write_cache_columns_kv, cu.write_cache_column)
    before = [w.launches for w in wrappers]
    gk, gv, gq, gkn, gvn, ganc = _t(*_group_inputs(8))
    with torch.no_grad():
        fa.flash_attention(q, k, v, bias, mask)
        fa.flash_attention_relpos(q, k, v, qr, pos, mask)
        ga.group_attend_anc(gk, gv, gq, gkn, gvn, ganc, 4)
        cu.write_cache_columns_kv(gk, gv, gkn, gvn, 4)
        cu.write_cache_column(gk, gkn, 4)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(RuntimeError, match="forward-only"):
        ga.group_attend_anc(gk, gv, gq.requires_grad_(), gkn, gvn, ganc, 4)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention(q.requires_grad_(), k, v, bias, mask)
    x = torch.zeros(1, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.fused_csgu(x, torch.ones(4), torch.zeros(4), torch.zeros(3, 1, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="one device"):
        fc.fused_csgu(x.detach(), torch.ones(4, device="meta"), torch.zeros(4),
                      torch.zeros(3, 1, 4), torch.zeros(4))



def _flash_check_inputs(b=24, h=4, t=500, dk=64, dtype=torch.float32, bias=True):
    """Inputs of K1 and K2 at a flagship shape (request (b) by default)."""
    g = torch.Generator().manual_seed(5)
    q, k, v, qr = (torch.randn(b, h, t, dk, generator=g).to(dtype) for _ in range(4))
    pos = torch.randn(h, 2 * t - 1, dk, generator=g).to(dtype)
    bb = torch.zeros(b, h, t, t, dtype=dtype) if bias else None
    return q, k, v, bb, qr, pos, torch.ones(b, t, dtype=torch.bool)


def test_flash_checks_refuse_what_the_kernel_does_not_take():
    """The flagship's f32 and bf16 shapes pass (K1 at request (b) 24 x 20 s,
    T = 500; K2 at request (a) 32 x 4 s, T = 100, with and without bias, and
    at the eval batch's 4 x 20 s); another type, another head dim, a
    non-contiguous input and a misaligned f32 view (both types copy 16 bytes
    at a time) raise."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, qr, pos, mask = _flash_check_inputs(dtype=dtype, bias=False)
        fa.check_inputs(fa._MODE_RELPOS, q, k, v, None, qr, pos, mask)
        for b, t in ((32, 100), (4, 500)):
            q, k, v, bias, _, _, mask = _flash_check_inputs(b=b, t=t, dtype=dtype)
            fa.check_inputs(fa._MODE_DENSE, q, k, v, bias, None, None, mask)
            fa.check_inputs(fa._MODE_NONE, q, k, v, None, None, None, mask)
    q, k, v, bias, qr, pos, mask = _flash_check_inputs(b=2, t=65)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.check_inputs(fa._MODE_NONE, *(x.half() for x in (q, k, v)), None, None, None, mask)
    with pytest.raises(ValueError, match="head dim"):
        fa.check_inputs(fa._MODE_NONE, *(x[..., :32].contiguous() for x in (q, k, v)), None, None,
                        None, mask)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_inputs(fa._MODE_NONE, q, k.transpose(2, 3).contiguous().transpose(2, 3), v, None,
                        None, None, mask)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_inputs(fa._MODE_RELPOS, q, k, v, None, qr, pos.transpose(1, 2).contiguous().transpose(1, 2),
                        mask)
    for name in ("q", "k", "v", "bias", "q_rel", "pos"):
        args = {"q": q, "k": k, "v": v, "bias": bias, "q_rel": None, "pos": None}
        mode = fa._MODE_DENSE
        if name in ("q_rel", "pos"):
            args.update(bias=None, q_rel=qr, pos=pos)
            mode = fa._MODE_RELPOS
        x = args[name]
        off = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
        assert off.is_contiguous() and off.data_ptr() % 16
        args[name] = off.copy_(x)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.check_inputs(mode, *args.values(), mask)


def test_chip_smokes_attention_phase_cuts_still_apply_to_the_f32_template():
    """``chip_smoke.py --attention-phases`` times copies of
    ``csrc/attention.cu`` with the f32 template's phases edited out, each
    edit at its first match: every edit must still find its text, and find
    it in the f32 template (before the bf16 ``namespace tc``)."""
    from chip_smoke import ATTENTION_F32_PHASE_CUTS
    from tailored_avsr_tpu_torch.kernels import build

    src = (build.CSRC / "attention.cu").read_text()
    for _, cuts in ATTENTION_F32_PHASE_CUTS:
        for old, new in cuts:
            at = src.find(old)
            assert 0 <= at < src.index("namespace tc {"), old
            src = src.replace(old, new, 1)
