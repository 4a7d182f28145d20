"""Host-side logic of the redesigned group attend (K4/K6) and the bf16
tensor-core flash attention (K1, K2), on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there, every forced split and the default
plan's split of a long cache included). What is checked here is what the
wrappers decide before a launch: the column split and chunk of
``group_attend_plan`` (every live column served once, the block's shared
memory within the H100's limit, a group split over blocks only when its
ancestry does not fit one, the flagship's choices), the checks that refuse
what the kernels do not take, and the arithmetic of the split: a PyTorch
emulation of the kernel's decomposition, written in this file (per block
the exact max, weights and sums of its columns, the step's own column in
the first block, partial (max, sum, accumulator) triples combined in
order), at forced plans and at the port's own plan, against the JAX
package's Pallas kernels in interpret mode, f32, tolerance 1e-5 (sums in
another order). The emulation is not the kernel: it shows that the plan's
decomposition is exact, not that the CUDA code computes it.

The same holds for bf16 K1's rel-pos term: a PyTorch emulation of its tile
assembly (per 64-row query block and 64-key tile the 127-row table span in
two 64-row chunks, rows outside [0, 2T-1) zero; per warp the 80-row window
at span row 48 - 16w multiplied into a 16 x 80 strip; entry (r, c) read
back from strip column 15 - r + c) against ``rel_shift(q_rel . pos^T)`` and,
through the attention, against the Pallas K1 in interpret mode, f32,
tolerance 1e-5.
"""

import math

import numpy as np
import pytest
import torch

from tailored_avsr_tpu.ops.flash_attention import flash_attention_relpos as pallas_relpos
from tailored_avsr_tpu.ops.group_attend import group_attend_anc as pallas_group_attend
from tailored_avsr_tpu.ops.group_attend import group_attend_anc_q as pallas_group_attend_q
from tailored_avsr_tpu_torch.ops import flash_attention as fa
from tailored_avsr_tpu_torch.ops import group_attend as ga
from tailored_avsr_tpu_torch.ops.attention import rel_shift
from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

ATOL = 1e-5


# ----------------------------------------------------------- the plan


@pytest.mark.parametrize("groups,esize,want", [
    (256, 2, (16, 64, 1)),  # LM (B=32, H=8), bf16: two blocks an SM, one wave
    (128, 2, (32, 64, 1)),  # decoder (H=4), bf16: one block an SM, wider chunks
    (256, 1, (16, 64, 1)),  # LM, int8 payload
    (128, 1, (32, 64, 1)),  # decoder, int8 payload
    (256, 4, (8, 56, 1)),   # LM, f32
    (32, 2, (32, 64, 1)),   # 4 utterances: still one block a group (idle SMs do not split it)
])
def test_plan_at_the_flagship_shapes(groups, esize, want):
    """Beam 10, pos 53 (52 live columns), 132 SMs."""
    assert ga.group_attend_plan(groups, 10, 52, esize) == want


@pytest.mark.parametrize("beam", [1, 3, 10, 30, 40, 64])
@pytest.mark.parametrize("esize", [1, 2, 4])
@pytest.mark.parametrize("groups,sms", [(1, 132), (32, 132), (128, 132), (256, 132), (4096, 132),
                                        (64, 16)])
def test_plan_serves_every_column_once_within_shared_memory(beam, esize, groups, sms):
    for n_live in (0, 1, 7, 31, 52, 103, 1000, 16383):
        chunk, per, split = ga.group_attend_plan(groups, beam, n_live, esize, sms=sms)
        n = max(n_live, 1)
        assert chunk in (1, 2, 4, 8, 16, 32) and per % chunk == 0
        assert (split - 1) * per < n <= split * per  # no empty block, no column left
        assert ga._smem_bytes(beam, chunk, per, esize) <= ga._SMEM_LIMIT
        assert split == 1 or beam * per <= ga._ANC_PAIRS  # a split block's ancestry fits
        # a group is split only when one block's ancestry would not fit
        assert split == 1 or beam * -(-n // chunk) * chunk > ga._ANC_PAIRS


@pytest.mark.parametrize("groups,n_live,esize,want", [
    (256, 103, 2, (16, 112, 1)),   # the flagship's longest step: one block
    (16, 384, 2, (32, 384, 1)),    # beam 10: a block holds 384 columns at chunk 32
    (16, 399, 2, (32, 224, 2)),    # one more chunk does not fit: two blocks
    (16, 1023, 1, (32, 352, 3)),   # Lc 1024 (the long-cache case of chip_smoke.py)
    (256, 1023, 2, (8, 344, 3)),   # the flagship LM's 256 groups: two blocks an SM need chunk 8
])
def test_plan_splits_a_group_only_when_its_ancestry_does_not_fit(groups, n_live, esize, want):
    assert ga.group_attend_plan(groups, 10, n_live, esize) == want


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="beam of 1 to 64"):
        ga.group_attend_plan(8, 65, 52, 2)
    with pytest.raises(ValueError, match="beam of 1 to 64"):
        ga.group_attend_plan(8, 0, 52, 2)


# ----------------------------------------------------------- input checks


def _group(b=2, h=2, km=3, lc=16, dk=64, dtype=torch.float32, cache_dtype=None):
    g = torch.Generator().manual_seed(0)
    cache = cache_dtype or dtype
    k, v = (torch.randn(b, h, km, lc, dk, generator=g).to(cache) for _ in range(2))
    q, k_new, v_new = (torch.randn(b, h, km, dk, generator=g).to(dtype) for _ in range(3))
    anc = torch.randint(-1, km + 1, (b, km, lc), generator=g, dtype=torch.int32)
    return k, v, q, k_new, v_new, anc


def _shape(args, pos=9, width=None, scales=(), cache_dtype=None, entry="avsr_group_attend"):
    k, v, q, k_new, v_new, anc = args
    return ga.launch_shape(entry, k, v, scales, q, k_new, v_new, anc, pos, width,
                           cache_dtype or q.dtype, sms=132)


def test_launch_shape_passes_the_plan_to_the_kernel():
    shape = _shape(_group(b=32, h=8, km=10, lc=104, dtype=torch.bfloat16), pos=53)
    assert shape == {"groups": 256, "heads": 8, "beam": 10, "lc": 104, "n_live": 52,
                     "chunk": 16, "per": 64, "split": 1}
    assert _shape(_group(), pos=100)["n_live"] == 16  # clamped to Lc
    assert _shape(_group(), pos=12, width=8)["n_live"] == 8  # and to the width
    assert _shape(_group(), pos=1)["n_live"] == 0
    k, v, q, k_new, v_new, anc = _group(b=32, h=8, km=10, lc=104, cache_dtype=torch.int8)
    scales = tuple(torch.ones(32, 8, 10, 104) for _ in range(2))
    shape = _shape((k, v, q, k_new, v_new, anc), pos=53, scales=scales, cache_dtype=torch.int8,
                   entry="avsr_group_attend_q")
    assert (shape["chunk"], shape["per"], shape["split"]) == (16, 64, 1)


def test_launch_shape_refuses_what_the_kernel_does_not_take():
    args = _group()
    with pytest.raises(ValueError, match="head dim 64"):
        _shape(_group(dk=32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _shape(_group(dtype=torch.float16))
    with pytest.raises(ValueError, match="beam of 1 to 64"):
        _shape(_group(km=65, lc=8))
    with pytest.raises(ValueError, match="multiple of 8"):
        _shape(args, width=12)
    with pytest.raises(ValueError, match="contiguous"):
        _shape((args[0].transpose(3, 4).contiguous().transpose(3, 4), *args[1:]))
    with pytest.raises(TypeError, match="int32"):
        _shape((*args[:5], args[5].long()))
    misaligned = torch.zeros(args[2].numel() + 1)[1:].view(args[2].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _shape((args[0], args[1], misaligned, *args[3:]))
    with pytest.raises(ValueError, match="k_scale"):
        _shape(_group(cache_dtype=torch.int8), scales=(torch.ones(2, 2, 3, 8), torch.ones(2, 2, 3, 16)),
               cache_dtype=torch.int8)


@pytest.mark.parametrize("lc,pos,launches", [(104, 53, 1), (1024, 1025, 2)])
def test_wrappers_count_the_combining_kernel(monkeypatch, lc, pos, launches):
    """A launch whose plan splits a group runs two kernels, and the wrapper
    counts both (the launch itself replaced: there is no card here)."""
    shapes = []
    monkeypatch.setattr(ga, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(ga, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ga, "_launch", lambda *args: shapes.append(args[-1]) or args[6])
    k, v, q, k_new, v_new, anc = _group(b=1, h=2, km=10, lc=lc, dtype=torch.bfloat16)
    scales = tuple(torch.ones(1, 2, 10, lc) for _ in range(2))
    kq, vq = k.to(torch.int8), v.to(torch.int8)
    for wrapper, args in ((ga.group_attend_anc, (k, v, q, k_new, v_new, anc, pos)),
                          (ga.group_attend_anc_q, (kq, scales[0], vq, scales[1], q, k_new, v_new, anc, pos))):
        before = wrapper.launches
        wrapper(*args)
        assert wrapper.launches - before == launches == 1 + (shapes[-1]["split"] > 1)


def _attn(b=2, h=2, t=40, dk=64, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, h, t, dk, generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(b, h, t, t, generator=g).to(dtype)
    return q, k, v, bias, torch.ones(b, t, dtype=torch.bool)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_checks_want_aligned_tensors_for_the_bf16_tensor_cores(dtype):
    """The bf16 K1 and K2 copy 16 bytes at a time; f32 K1 and K2 (FMA
    template) take any alignment."""
    q, k, v, bias, mask = _attn(dtype=dtype)
    fa.check_inputs(fa._MODE_DENSE, q, k, v, bias, None, None, mask)
    off = torch.zeros(bias.numel() + 1, dtype=dtype)[1:].view(bias.shape)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.check_inputs(fa._MODE_DENSE, q, k, v, off, None, None, mask)
    else:
        fa.check_inputs(fa._MODE_DENSE, q, k, v, off, None, None, mask)
    pos = torch.randn(2, 2 * q.shape[2] - 1, 64).to(dtype)
    fa.check_inputs(fa._MODE_RELPOS, q, k, v, None, q, pos, mask)
    with pytest.raises(ValueError, match="head dim"):
        fa.check_inputs(fa._MODE_NONE, *(x[..., :32].contiguous() for x in (q, k, v)), None, None,
                        None, mask)
    with pytest.raises(ValueError, match="bias"):
        fa.check_inputs(fa._MODE_DENSE, q, k, v, bias[:, :, :, :-1].contiguous(), None, None, mask)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relpos_checks_want_aligned_q_rel_and_table_in_bf16(dtype):
    """bf16 K1 copies q_rel and the rel table by 16-byte cp.async too: a
    misaligned q_rel, or a table that starts off a 16-byte boundary (a
    caller's view), is refused; f32 K1 takes them."""
    q, k, v, _, mask = _attn(dtype=dtype)
    t = q.shape[2]
    pos = torch.randn(2, 2 * t - 1, 64).to(dtype)
    off_q = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    off_pos = torch.zeros(pos.numel() + 1, dtype=dtype)[1:].view(pos.shape)
    fa.check_inputs(fa._MODE_RELPOS, q, k, v, None, q, pos, mask)
    for q_rel, table in ((off_q, pos), (q, off_pos)):
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="q_rel and pos must be 16-byte aligned"):
                fa.check_inputs(fa._MODE_RELPOS, q, k, v, None, q_rel, table, mask)
        else:
            fa.check_inputs(fa._MODE_RELPOS, q, k, v, None, q_rel, table, mask)


# ----------------------------------------------------------- K1's rel-pos tiles


def _relpos_bias_by_tiles(q_rel: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """bf16 K1's assembly of rel_shift(q_rel . pos^T), in f32: (B, H, T, dk)
    and (H, 2T-1, dk) -> (B, H, T, T), written tile by tile as the kernel
    reads it into its scores."""
    b, h, t, dk = q_rel.shape
    n_pos, blk = 2 * t - 1, 64
    out = torch.full((b, h, t, t), float("nan"))
    lr, c = torch.arange(16)[:, None], torch.arange(blk)[None, :]
    for q0 in range(0, t, blk):
        table0 = t - q0 - blk  # table row of chunk 0's first row

        def chunk(n):  # 64 table rows; those outside [0, 2T-1) read as 0
            rows = table0 + n * blk + torch.arange(blk)
            ok = (rows >= 0) & (rows < n_pos)
            return torch.where(ok[None, :, None], pos[:, rows.clamp(0, n_pos - 1)], 0.0)

        qr = torch.zeros(b, h, blk, dk)
        qr[:, :, :min(blk, t - q0)] = q_rel[:, :, q0:q0 + blk]
        for kt in range(-(-t // blk)):
            span = torch.cat([chunk(kt), chunk(kt + 1)], dim=1)  # span row sr: table row table0 + 64kt + sr
            for w in range(blk // 16):
                if q0 + 16 * w >= t:
                    continue  # the warp's rows all lie past T
                window = span[:, 48 - 16 * w:48 - 16 * w + 80]  # (H, 80, dk)
                strip = qr[:, :, 16 * w:16 * w + 16] @ window.transpose(1, 2)  # (B, H, 16, 80)
                tile = strip[:, :, lr, 15 - lr + c]  # (B, H, 16, 64)
                i, j = q0 + 16 * w + lr, kt * blk + c
                keep = (i < t) & (j < t)
                out[:, :, i.expand_as(keep)[keep], j.expand_as(keep)[keep]] = tile[:, :, keep]
    return out


@pytest.mark.parametrize("t", [1, 16, 63, 64, 65, 100, 129])
def test_relpos_tiles_match_rel_shift_and_pallas(t):
    """Every entry of the bias comes from the tiles, equal to rel_shift(q_rel .
    pos^T); attention with it equals the Pallas K1 (interpret mode), an
    utterance fully masked (exactly 0) and one ragged."""
    rs = np.random.RandomState(t)
    b, h, dk = 3, 2, 16
    q, k, v, qr = (rs.randn(b, h, t, dk).astype(np.float32) for _ in range(4))
    pos = rs.randn(h, 2 * t - 1, dk).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 0, max(1, t // 2 + 1)])[:, None]
    bias = _relpos_bias_by_tiles(torch.from_numpy(qr), torch.from_numpy(pos))
    want_bias = rel_shift(torch.from_numpy(qr) @ torch.from_numpy(pos).transpose(1, 2))
    np.testing.assert_allclose(bias.numpy(), want_bias.numpy(), atol=ATOL)
    got = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), bias, torch.from_numpy(mask))
    want = pallas_relpos(q, k, v, qr, pos, mask, block=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[1].any() and not np.asarray(want)[1].any()


# ----------------------------------------------------------- split and combine


def _emulate(k, v, q, k_new, v_new, anc, pos, width, per, split, k_scale=None, v_scale=None):
    """The kernel's arithmetic in PyTorch, f32: block s of a group serves
    columns [s*per, min(n_live, (s+1)*per)): its exact max (the step's own
    column included in block 0), weights, their sum and the weighted values;
    then the blocks' (max, sum, accumulator) triples are combined in order."""
    b, h, km, lc, dk = k.shape
    n_live = max(0, min(pos - 1, width or lc))
    scale = 1.0 / math.sqrt(dk)
    kf, vf = k.float(), v.float()
    out = torch.empty(b, h, km, dk)
    for bb in range(b):
        for hh in range(h):
            for i in range(km):
                qv = q[bb, hh, i].float()
                triples = []
                for s in range(split):
                    live = [(t, int(anc[bb, i, t])) for t in range(s * per, min(n_live, (s + 1) * per))
                            if 0 <= int(anc[bb, i, t]) < km]
                    logits = [float(qv @ kf[bb, hh, j, t]) * scale
                              * (1.0 if k_scale is None else float(k_scale[bb, hh, j, t])) for t, j in live]
                    s_new = float(qv @ k_new[bb, hh, i].float()) * scale if s == 0 else -math.inf
                    m = max([s_new, *logits])
                    p = [math.exp(x - m) for x in logits]
                    p_new = math.exp(s_new - m) if s == 0 else 0.0
                    acc = p_new * v_new[bb, hh, i].float()
                    for w, (t, j) in zip(p, live):
                        vs = 1.0 if v_scale is None else float(v_scale[bb, hh, j, t])
                        acc = acc + w * vs * vf[bb, hh, j, t]
                    triples.append((m, p_new + sum(p), acc))
                mx = max(t[0] for t in triples)
                lsum = sum(math.exp(t[0] - mx) * t[1] for t in triples if t[1] > 0)
                out[bb, hh, i] = sum(math.exp(t[0] - mx) * t[2] for t in triples if t[1] > 0) / lsum
    return out


@pytest.mark.parametrize("chunk,split", [(4, 1), (4, 3), (8, 2), (2, 5), (32, 1)])
def test_split_and_combine_match_pallas(chunk, split):
    """Any chunk and split the plan may choose give the Pallas kernel's
    result at every position of a small cache, a narrowed width included,
    with anc entries outside [0, K)."""
    k, v, q, k_new, v_new, anc = _group(b=2, h=2, km=3, lc=24, dk=16)
    npy = [x.numpy() for x in (k, v, q, k_new, v_new, anc)]
    for pos, width in ((1, None), (2, None), (9, None), (17, None), (25, None), (20, 16)):
        n = max(1, min(pos - 1, width or 24))
        per = -(-(-(-n // split)) // chunk) * chunk
        want = pallas_group_attend(*npy, pos, width=width, interpret=True)
        got = _emulate(k, v, q, k_new, v_new, anc, pos, width, per, -(-n // per))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"pos {pos} width {width}")
        if pos == 1:
            assert torch.equal(got, v_new)  # only the step's own column


@pytest.mark.parametrize("split", [1, 2])
def test_split_and_combine_match_pallas_over_an_int8_cache(split):
    """K6's folding: the key scale on the logit, the value scale on the
    accumulator's weight and not on the sum."""
    k, v, q, k_new, v_new, anc = _group(b=1, h=2, km=3, lc=64, dk=16)
    (kq, ks), (vq, vs) = quantize_kv_column(k), quantize_kv_column(v)
    for pos in (2, 33, 65):
        n = min(pos - 1, 64)
        per = -(-(-(-n // split)) // 8) * 8
        want = pallas_group_attend_q(kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy(), q.numpy(),
                                     k_new.numpy(), v_new.numpy(), anc.numpy(), pos, interpret=True)
        got = _emulate(kq, vq, q, k_new, v_new, anc, pos, None, per, -(-n // per), ks, vs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"pos {pos}")


def test_split_and_combine_match_pallas_at_the_ports_plan():
    """The plan the port launches on a cache whose ancestry takes several
    blocks (beam 3, more than 1,365 live columns), emulated, against Pallas."""
    k, v, q, k_new, v_new, anc = _group(b=1, h=1, km=3, lc=1400, dk=16)
    npy = [x.numpy() for x in (k, v, q, k_new, v_new, anc)]
    for pos, width in ((1401, None), (1000, None), (1401, 1392)):
        n = min(pos - 1, width or 1400)
        _, per, split = ga.group_attend_plan(1, 3, n, k.element_size())
        want = pallas_group_attend(*npy, pos, width=width, interpret=True)
        got = _emulate(k, v, q, k_new, v_new, anc, pos, width, per, split)
        assert split == (2 if n > 1344 else 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"pos {pos} width {width}")
