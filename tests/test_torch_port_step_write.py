"""The step write (every cached layer's K and V column of one beam step in
one launch, ``ops/cache_update.write_step_columns``) on the CPU.

On the CPU the wrapper runs its plain version, the loop of
``write_cache_columns_kv_plain`` over the layers plus the int8 scale
writes; the CUDA kernel is held to it bit for bit on the card by
``chip_smoke.py``. Here the plain step write, through the beam search's
``write_beam_step``, is held bit for bit to the JAX package's per-layer
``write_beam_columns_kv`` with its Pallas writes in interpret mode (and its
int8 scale writes), over layers of mixed H and Lc, step columns that are
strided views as the fused q/k/v projection gives them, f32 and bf16
caches and an int8 cache, at pos 1, a middle pos and past Lc (the clamp).
The host-side table the kernel takes (``step_leaf_table``: pointers, rows,
strides, Lc, the clamped column, the 16-byte vector choice) is checked as
a plain function, its strides by reading the sources through them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.decode.beam_search import write_beam_columns_kv as jax_write
from tailored_avsr_tpu_torch.decode.beam_search import write_beam_step
from tailored_avsr_tpu_torch.ops import cache_update as cu
from tailored_avsr_tpu_torch.ops.group_attend import to_group
from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

B, K, DK = 2, 3, 8
LAYERS = ((2, 16), (4, 24), (2, 8))  # (H, Lc) of each cached layer: mixed heads and widths


def _steps(rs, h, dtype, dk=DK):
    """(N, H, 1, dk) K and V step columns as strided views of one fused
    (N, 1, 3*H*dk) projection, as ``project_qkv`` returns them."""
    y = torch.from_numpy(rs.randn(B * K, 1, 3 * h * dk).astype(np.float32)).to(dtype)
    kn, vn = (y[..., j * h * dk:(j + 1) * h * dk].reshape(B * K, 1, h, dk).transpose(1, 2) for j in (1, 2))
    assert not kn.is_contiguous() and kn.shape == (B * K, h, 1, dk)
    return kn, vn


def _caches(rs, h, lc, dtype, dk=DK):
    if dtype == torch.int8:
        def side():
            return (torch.from_numpy(rs.randint(-127, 128, (B, h, K, lc, dk)).astype(np.int8)),
                    torch.from_numpy(rs.rand(B, h, K, lc).astype(np.float32)))
    else:
        def side():
            return torch.from_numpy(rs.randn(B, h, K, lc, dk).astype(np.float32)).to(dtype)
    return side(), side()


def _jax(x):
    if isinstance(x, tuple):
        return tuple(_jax(a) for a in x)
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16 if x.dtype == torch.bfloat16 else None) \
        if x.is_floating_point() else jnp.asarray(x.numpy())


def _flat(x):
    return [*x] if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("cache_dtype,col_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.int8, torch.float32), (torch.int8, torch.bfloat16)])
def test_step_write_matches_the_jax_pallas_writes_bit_exact(monkeypatch, cache_dtype, col_dtype):
    """One ``write_beam_step`` over all layers against the JAX per-layer
    writes (Pallas, interpret mode): caches, and for the int8 cache the
    payloads and scale planes, equal bit for bit at every pos."""
    monkeypatch.setenv("TAVSR_FORCE_PALLAS_WRITES", "1")
    rs = np.random.RandomState(21)
    # the Pallas int8 write reads 32-column blocks: Lc a multiple of 32
    layers = [(h, lc * 4 if cache_dtype == torch.int8 else lc) for h, lc in LAYERS]
    caches = [_caches(rs, h, lc, cache_dtype) for h, lc in layers]
    jcaches = [tuple(_jax(s) for s in sides) for sides in caches]
    lcs = sorted(lc for _, lc in layers)
    before = cu.write_step_columns.launches
    # the first column, a middle one, past the narrowest cache, past every cache (the clamp)
    for pos in (1, 6, lcs[0] + 1, lcs[-1] + 6):
        steps = [_steps(rs, h, col_dtype) for h, _ in layers]
        write_beam_step([(ck, cv, kn, vn) for (ck, cv), (kn, vn) in zip(caches, steps)], pos)
        jcaches = [jax_write(jk, jv, _jax(kn), _jax(vn), pos) for (jk, jv), (kn, vn) in zip(jcaches, steps)]
        for sides, jsides in zip(caches, jcaches):
            for got, want in zip((*_flat(sides[0]), *_flat(sides[1])), (*_flat(jsides[0]), *_flat(jsides[1]))):
                np.testing.assert_array_equal(got.float().numpy() if got.is_floating_point() else got.numpy(),
                                              np.asarray(want.astype(jnp.float32) if got.is_floating_point()
                                                         else want), err_msg=f"pos {pos}")
    assert cu.write_step_columns.launches == before  # CPU tensors: the plain version


def test_step_write_is_the_loop_of_per_layer_writes():
    """``write_step_columns`` on quantised (payload, scale) step columns
    equals the per-layer K5 plain writes plus indexed scale writes; only
    column min(pos - 1, Lc - 1) changes."""
    rs = np.random.RandomState(22)
    for pos in (1, 5, 40):
        caches = [_caches(rs, h, lc, torch.int8) for h, lc in LAYERS]
        want = [tuple(tuple(t.clone() for t in side) for side in sides) for sides in caches]
        steps = [tuple(quantize_kv_column(x) for x in _steps(rs, h, torch.float32)) for h, _ in LAYERS]
        cu.write_step_columns([(ck, cv, kn, vn) for (ck, cv), (kn, vn) in zip(caches, steps)], pos)
        for ((wkp, wks), (wvp, wvs)), (kn, vn), (h, lc) in zip(want, steps, LAYERS):
            cu.write_cache_columns_kv_plain(wkp, wvp, to_group(kn[0], K), to_group(vn[0], K), pos - 1)
            col = min(pos - 1, lc - 1)
            wks[:, :, :, col] = to_group(kn[1][..., None], K)[..., 0]
            wvs[:, :, :, col] = to_group(vn[1][..., None], K)[..., 0]
        for sides, wsides in zip(caches, want):
            for got, w in zip((*sides[0], *sides[1]), (*wsides[0], *wsides[1])):
                assert torch.equal(got, w), f"pos {pos}"


def test_leaf_table_holds_rows_strides_and_the_clamped_column():
    rs = np.random.RandomState(23)
    caches = [_caches(rs, h, lc, torch.bfloat16) for h, lc in LAYERS]
    steps = [_steps(rs, h, torch.bfloat16) for h, _ in LAYERS]
    leaves = [(ck, cv, kn, vn) for (ck, cv), (kn, vn) in zip(caches, steps)]
    table, cache_dtype, col_dtype, dk, vec = cu.step_leaf_table(leaves, 15)
    assert (cache_dtype, col_dtype, dk, vec) == (torch.bfloat16, torch.bfloat16, DK, 1)
    assert table.dtype == cu.LEAF_DTYPE and cu.LEAF_DTYPE.itemsize == 120  # csrc's StepLeaf
    for rec, (ck, cv, kn, vn), (h, lc) in zip(table, leaves, LAYERS):
        assert (rec["heads"], rec["beam"], rec["lc"], rec["rows"]) == (h, K, lc, B * h * K)
        assert rec["col"] == min(15, lc - 1)
        assert list(rec["ptr"]) == [ck.data_ptr(), cv.data_ptr(), kn.data_ptr(), vn.data_ptr(), 0, 0, 0, 0]
        # the kernel reads source element (b, h, i, d) at b*sb + h*sh + i*si + d
        assert tuple(rec["k_stride"]) == (K * 3 * h * DK, DK, 3 * h * DK)
        for x, st in ((kn, rec["k_stride"]), (vn, rec["v_stride"])):
            read = torch.as_strided(x, (B, h, K, DK), (*map(int, st), 1), x.storage_offset())
            assert torch.equal(read, to_group(x, K))
        assert tuple(rec["s_stride"]) == (0, 0, 0)
    # group-layout (B, H, K, dk) columns, the per-layer K5 form, one tensor (K5')
    (ck, cv), (h, lc) = caches[1], LAYERS[1]
    col = to_group(steps[1][0], K)
    table, *_ = cu.step_leaf_table([(ck, None, col, None)], 100)
    assert tuple(table[0]["k_stride"]) == col.stride()[:3] and table[0]["col"] == lc - 1
    assert table[0]["ptr"][1] == 0 and tuple(table[0]["v_stride"]) == (0, 0, 0)


def test_leaf_table_of_an_int8_step_and_the_vector_choice():
    rs = np.random.RandomState(24)
    (ck, cv), (h, lc) = _caches(rs, 2, 16, torch.int8), LAYERS[0]
    (kq, ks), (vq, vs) = (quantize_kv_column(x) for x in _steps(rs, 2, torch.float32))
    table, cache_dtype, col_dtype, dk, vec = cu.step_leaf_table([(ck, cv, (kq, ks), (vq, vs))], 0)
    assert (cache_dtype, col_dtype) == (torch.int8, torch.int8)
    assert vec == 0  # dk 8 is no multiple of a 16-byte int8 copy's 16 elements
    rec = table[0]
    assert list(rec["ptr"][4:]) == [ck[1].data_ptr(), cv[1].data_ptr(), ks.data_ptr(), vs.data_ptr()]
    read = torch.as_strided(ks, (B, 2, K), tuple(map(int, rec["s_stride"])), ks.storage_offset())
    assert torch.equal(read, to_group(ks[..., None], K)[..., 0])
    # with dk 64 the int8 payloads take 16-byte copies (the scales' unit
    # strides do not count: a scale is one element)
    (ck, cv) = _caches(rs, 2, 16, torch.int8, dk=64)
    (kq, ks), (vq, vs) = (quantize_kv_column(x) for x in _steps(rs, 2, torch.float32, dk=64))
    assert cu.step_leaf_table([(ck, cv, (kq, ks), (vq, vs))], 0)[4] == 1
    # a misaligned f32 source takes one element a copy
    y = torch.zeros(B * K * 2 * DK + 1)[1:].view(B * K, 2, 1, DK)
    c32 = torch.zeros(B, 2, K, 16, DK)
    assert cu.step_leaf_table([(c32, None, y, None)], 0)[4] == 0
    assert cu.step_leaf_table([(c32, None, y.clone(), None)], 0)[4] == 1


def test_leaf_table_refuses_what_the_kernel_does_not_take(monkeypatch):
    rs = np.random.RandomState(25)
    (ck, cv), kn = _caches(rs, 2, 16, torch.float32), _steps(rs, 2, torch.float32)[0]
    with pytest.raises(ValueError, match="one cache/column dtype pair"):
        cu.step_leaf_table([(ck, None, kn, None), (ck.bfloat16(), None, kn, None)], 0)
    with pytest.raises(ValueError, match="expected shape"):
        cu.step_leaf_table([(ck, None, kn[:, :1], None)], 0)
    with pytest.raises(ValueError, match="contiguous"):
        cu.step_leaf_table([(ck.transpose(0, 1).contiguous().transpose(0, 1), None, kn, None)], 0)
    with pytest.raises(ValueError, match="V column"):
        cu.step_leaf_table([(ck, cv, kn, None)], 0)
    with pytest.raises(TypeError, match="int8 cache and int8 columns"):
        cu.step_leaf_table([(ck.to(torch.int8), None, kn, None)], 0)
    with pytest.raises(TypeError, match="payload, scale"):
        cu.step_leaf_table([((ck.to(torch.int8), ck[..., 0]), None, kn, None)], 0)
    with pytest.raises(ValueError, match=">= 0"):
        cu.step_leaf_table([(ck, None, kn, None)], -1)
    # one launch's parameter table holds 32 layers (checked before any build)
    monkeypatch.setattr(cu, "use_kernel", lambda *tensors: True)
    with pytest.raises(ValueError, match="at most 32 layers"):
        cu.write_step_columns([(ck, cv, kn, kn)] * 33, 1)
