"""The port's int8 decode mode (``cache_dtype`` / ``mem_dtype: int8``) and its
last kernels against the JAX package, in f32 on the CPU; and the port's two
guards: its own key-grammar export, and no silent CPU.

Modules: ``ops/kv_quant.py`` (bit-exact), the K6 group attend's plain
version against the Pallas kernel in interpret mode, ``attend_kv_anc`` and
``attend_kv_mem_grouped`` over int8 sides, the int8 column writes (K5's
plain version and ``write_beam_columns_kv``, bit-exact, against both JAX
write paths), the decoder's and the LM's ``score_step_anc`` over int8
caches, then ``Speech2Text.nbest`` with the int8 cache, the int8 memory,
both, both with phased widths, against the JAX engine with its Pallas path,
and at full width. P1 (``stream_abs_sum``) against numpy and against the
TPU kernel's own output, run in interpret mode.

Tolerances: the quantiser and the writes are bit-exact; K6's plain version
against the Pallas kernel rtol 2e-4 / atol 2e-5 (as
``tests/test_group_attend.py``: the kernel multiplies the int8 payload and
folds the scales, the plain version dequantises first); the attends and
score steps 1e-5 abs (f32 sums in another order); token ids identical; beam
scores 1e-4, but ``INT8_BOTH_SCORE_ATOL`` for the one case that needs more
(see there, and the test that witnesses it); P1 relative 1e-6 (f32 sums of a
few thousand terms in another order).
"""

import ast
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import __graft_entry__ as graft
from test_torch_port_beam import LM_FULL, LM_TINY, _engines, _mha, _same_nbest, _walk_beam, close
from test_torch_port_ops import jax_module, load_port, t
from test_torch_port_slice import TOKENS, _batch, _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Beam scores with the int8 cache and the int8 memory together, at tiny
# width, unphased: the two packages' columns differ by about 3e-7 of a
# column's max (their encoders' f32 sums run in another order), and a value
# that close to a rounding boundary of its int8 step (1/127 of the column's
# max) lands one step apart; one such step moves a logit by up to
# |q| * step / sqrt(dk), and the int8 memory's steps move the decoder's
# columns, so the cache's steps follow. Against the JAX engine the largest
# score difference is 1.3e-4; noise of that size on the port's own columns
# moves its scores by up to 2.0e-4
# (``test_int8_scores_move_by_more_than_1e4_under_the_packages_gap``), while
# a wrong scale or payload moves them by O(1) and changes ids. Every other
# int8 case reads below 1e-4 and is held to it.
INT8_BOTH_SCORE_ATOL = 5e-4


def _quantize_jax(x):
    """(payload, scale) numpy pair from the JAX quantiser."""
    from tailored_avsr_tpu.ops.kv_quant import quantize_kv_column

    q, s = quantize_kv_column(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


# ------------------------------------------------------------- kv_quant


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_column_bit_exact(dtype):
    """Random columns of several scales, all-zero columns (scale 0), and a
    column whose steps land on exact halves (round half to even)."""
    from tailored_avsr_tpu.ops import kv_quant as J
    from tailored_avsr_tpu_torch.ops import kv_quant as P

    rs = np.random.RandomState(0)
    x = (rs.randn(3, 4, 5, 64) * rs.choice([1e-3, 1.0, 30.0], (3, 4, 5, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[1, 0] = 0.0
    x[2, 3, 4, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]  # scale exactly 1
    x[2, 3, 4, 6:] = 0.0
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    px = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    jq, js = J.quantize_kv_column(jx)
    pq, ps = P.quantize_kv_column(px)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert (ps[1, 0] == 0).all() and (pq[1, 0] == 0).all()
    np.testing.assert_array_equal(pq[2, 3, 4, :6].numpy(), [127, 2, -4, 0, 0, 2])
    got = P.dequantize_cache(pq, ps, TORCH_DTYPES[dtype])
    want = J.dequantize_cache(jq, js, jnp.dtype(dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# -------------------------------------------------------------- K6


def _k6_case(seed, b, h, km, lc, dk):
    rs = np.random.RandomState(seed)
    (kq, ks), (vq, vs) = (_quantize_jax(rs.randn(b, h, km, lc, dk).astype(np.float32)) for _ in range(2))
    q, k_new, v_new = (rs.randn(b, h, km, dk).astype(np.float32) for _ in range(3))
    anc = rs.randint(0, km, (b, km, lc)).astype(np.int32)
    return kq, ks, vq, vs, q, k_new, v_new, anc


@pytest.mark.parametrize("pos,width", [(1, None), (2, None), (20, None), (64, None), (20, 32), (33, 32)])
def test_k6_plain_matches_pallas(pos, width):
    """K6's plain version (and its wrapper on CPU tensors) against the Pallas
    ``group_attend_anc_q`` in interpret mode; at pos 1 the output is
    exactly v_new."""
    from tailored_avsr_tpu.ops.group_attend import group_attend_anc_q as pallas_q
    from tailored_avsr_tpu_torch.ops import group_attend as ga

    args = _k6_case(pos, 2, 2, 3, 64, 64)
    want = np.asarray(pallas_q(*args, pos, width=width, interpret=True))
    before = ga.group_attend_anc_q.launches
    for fn in (ga.group_attend_anc_q_plain, ga.group_attend_anc_q):
        got = fn(*(t(a) for a in args), pos, width=width)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
        if pos == 1:
            assert torch.equal(got, t(args[6]))
    assert ga.group_attend_anc_q.launches == before  # CPU tensors: the plain version


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("pos,width", [(1, None), (5, None), (20, 32), (30, None)])
def test_attend_kv_anc_int8_matches_jax(pos, width):
    """Tuple (payload, scale) cache sides through both port formulations
    (the K6 route, its plain version on the CPU, and ``fused=False``)
    against the JAX dequantising XLA twin; the ancestry table is narrower
    than Lc."""
    jm, v, pm = _mha(4)
    rs = np.random.RandomState(11)
    b, beam, lc = 2, 3, 40
    kc, vc = (_quantize_jax(rs.randn(b, 4, beam, lc, 8).astype(np.float32)) for _ in range(2))
    k_new, v_new, q = (rs.randn(b * beam, 4, 1, 8).astype(np.float32) for _ in range(3))
    anc = rs.randint(0, beam, (b * beam, 36)).astype(np.int32)
    want = jm.apply(v, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)), k_new, v_new, anc, pos,
                    beam, q, width, False, method="attend_kv_anc")
    with torch.no_grad():
        for fused in (None, False):
            got = pm.attend_kv_anc((t(kc[0]), t(kc[1])), (t(vc[0]), t(vc[1])), t(k_new), t(v_new), t(anc),
                                   pos, beam, t(q), width=width, fused=fused)
            close(got, want)


@pytest.mark.parametrize("masked", [True, False])
def test_attend_kv_mem_grouped_int8_matches_jax(masked):
    jm, v, pm = _mha(2)
    rs = np.random.RandomState(12)
    b, beam, tm = 2, 3, 7
    query = rs.randn(b * beam, 1, 32).astype(np.float32)
    mk, mv = (_quantize_jax(rs.randn(b, 4, tm, 8).astype(np.float32)) for _ in range(2))
    mask = (np.arange(tm)[None] < np.array([7, 5])[:, None]) if masked else None
    want = jm.apply(v, query, tuple(map(jnp.asarray, mk)), tuple(map(jnp.asarray, mv)), mask, beam,
                    method="attend_kv_mem_grouped")
    with torch.no_grad():
        got = pm.attend_kv_mem_grouped(t(query), (t(mk[0]), t(mk[1])), (t(mv[0]), t(mv[1])),
                                       None if mask is None else t(mask), beam)
    close(got, want)


# ----------------------------------------------------------- the writes


def test_k5_int8_plain_matches_pallas_bit_exact():
    """K5's plain version (and its wrapper on CPU tensors) on an int8 cache
    against the Pallas write in interpret mode (its 32-row int8 block),
    every fourth column and past the last (the clamp)."""
    from tailored_avsr_tpu.ops.cache_update import write_cache_columns_kv as pallas_write_kv
    from tailored_avsr_tpu_torch.ops import cache_update as cu

    rs = np.random.RandomState(13)
    b, h, km, lc, dk = 2, 2, 3, 64, 16
    kc, vc = (rs.randint(-127, 128, (b, h, km, lc, dk)).astype(np.int8) for _ in range(2))
    before = cu.write_cache_columns_kv.launches
    for pos in list(range(0, lc, 4)) + [lc - 1, lc, lc + 5]:
        kcol, vcol = (rs.randint(-127, 128, (b, h, km, dk)).astype(np.int8) for _ in range(2))
        wk, wv = pallas_write_kv(kc, vc, kcol, vcol, pos, interpret=True)
        for fn in (cu.write_cache_columns_kv_plain, cu.write_cache_columns_kv):
            gk, gv = fn(t(kc).clone(), t(vc).clone(), t(kcol), t(vcol), pos)
            assert gk.dtype == torch.int8
            np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert cu.write_cache_columns_kv.launches == before


@pytest.mark.parametrize("pallas_writes", ["0", "1"])
def test_write_beam_columns_kv_int8_bit_exact(pallas_writes, monkeypatch):
    """``write_beam_columns_kv`` on (payload, scale) sides over several steps:
    payloads and scale planes bit-exact against the JAX function, through
    its XLA writes and through its Pallas writes in interpret mode."""
    from tailored_avsr_tpu.decode.beam_search import write_beam_columns_kv as jwrite
    from tailored_avsr_tpu_torch.decode.beam_search import write_beam_columns_kv as pwrite

    monkeypatch.setenv("TAVSR_FORCE_PALLAS_WRITES", pallas_writes)
    rs = np.random.RandomState(14)
    b, h, km, lc, dk = 2, 2, 3, 32, 8

    def side():
        return np.zeros((b, h, km, lc, dk), np.int8), np.zeros((b, h, km, lc), np.float32)

    jk, jv = side(), side()
    pk, pv = (tuple(t(a) for a in s) for s in (side(), side()))
    for pos in range(1, 7):
        k_new, v_new = (rs.randn(b * km, h, 1, dk).astype(np.float32) * (1 + pos) for _ in range(2))
        jk, jv = jwrite(jk, jv, jnp.asarray(k_new), jnp.asarray(v_new), pos)
        pk, pv = pwrite(pk, pv, t(k_new), t(v_new), pos)
        for got, want in zip((*pk, *pv), (*jk, *jv)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(pk[1].abs().sum()) > 0 and int(pk[0].abs().sum()) > 0


# ------------------------------------------------------ decoder and LM


def test_decoder_score_step_anc_int8():
    """The decoder over int8 group caches and int8 memory K/V: each step's
    log-probs against the JAX decoder over its own int8 caches (Lc 16 here,
    32 in JAX: the pad columns are never live)."""
    from tailored_avsr_tpu.decode.beam_search import write_beam_columns_kv as jwrite
    from tailored_avsr_tpu.models.decoder import TransformerDecoder as J
    from tailored_avsr_tpu.ops.kv_quant import quantize_kv_column as jquant
    from tailored_avsr_tpu_torch.decode.beam_search import write_beam_columns_kv as pwrite
    from tailored_avsr_tpu_torch.models.decoder import TransformerDecoder as P
    from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column as pquant

    rs = np.random.RandomState(15)
    b, beam, tm, d, vocab = 2, 3, 9, 32, 11
    conf = dict(encoder_output_size=d, attention_heads=4, linear_units=40, num_blocks=2,
                dropout_rate=0.0, positional_dropout_rate=0.0)
    mem = rs.randn(b, tm, d).astype(np.float32)
    mem_mask = np.arange(tm)[None] < np.array([9, 6])[:, None]
    ys_in = rs.randint(0, vocab, (b, 5)).astype(np.int32)
    jm = J(vocab, **conf)
    v = jax_module(jm, mem, mem_mask, ys_in, np.array([5, 3], np.int32))
    pm = load_port(P(vocab, **conf), v, "decoder")
    mem_kv_j = [(jquant(mk), jquant(mv)) for mk, mv in jm.apply(v, mem, method="precompute_memory")]
    cache_j = [jm.init_cache_group(b, beam, tm, quantized=True)]
    with torch.no_grad():
        mem_kv_p = [(pquant(mk), pquant(mv)) for mk, mv in pm.precompute_memory(t(mem))]
        cache_p = pm.init_cache_group(b, beam, tm, quantized=True)
    (pkp, pks), _ = cache_p[0]
    assert pkp.dtype == torch.int8 and tuple(pkp.shape) == (b, 4, beam, 16, 8)
    assert pks.dtype == torch.float32 and tuple(pks.shape) == (b, 4, beam, 16)

    def jax_step(ys, pos, anc):
        return jm.apply(v, mem_kv_j, mem_mask, ys, pos, cache_j[0], anc, beam, method="score_step_anc")

    def port_step(ys, pos, anc):
        with torch.no_grad():
            return pm.score_step_anc(mem_kv_p, t(mem_mask), ys, pos, cache_p, anc, beam)

    def jax_write(new_kv, pos):
        cache_j[0] = [jwrite(ck, cv, kn, vn, pos) for (ck, cv), (kn, vn) in zip(cache_j[0], new_kv)]

    def port_write(new_kv, pos):
        for (ck, cv), (kn, vn) in zip(cache_p, new_kv):
            pwrite(ck, cv, kn, vn, pos)

    _walk_beam(jax_step, port_step, jax_write, port_write, 6, b, beam, 16, seed=16)
    # the columns come from f32 projections that agree to ~1e-7, not bit for
    # bit: a scale may differ in its last bits and a payload by one step
    for (gk, gv), (wk, wv) in zip(cache_p, cache_j[0]):
        for (gp, gs), (wp, ws) in ((gk, wk), (gv, wv)):
            assert np.abs(gp.numpy().astype(int) - np.asarray(wp)[:, :, :, :16].astype(int)).max() <= 1
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws)[:, :, :, :16], rtol=1e-5, atol=0)


def test_lm_score_step_anc_int8():
    from tailored_avsr_tpu.decode.beam_search import write_beam_columns_kv as jwrite
    from tailored_avsr_tpu.models.lm import TransformerLM as J
    from tailored_avsr_tpu_torch.decode.beam_search import write_beam_columns_kv as pwrite
    from tailored_avsr_tpu_torch.models.lm import TransformerLM as P
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_lm_variables

    rs = np.random.RandomState(17)
    b, beam, vocab = 2, 3, 11
    conf = dict(att_unit=32, head=4, unit=40, layer=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                embed_unit=None, pos_enc="sinusoidal")
    tokens = rs.randint(0, vocab, (b, 6)).astype(np.int32)
    jm = J(vocab, **conf)
    v = jax_module(jm, tokens, np.array([6, 4], np.int32))
    pm = P(vocab, **conf)
    pm.load_state_dict(convert_jax_lm_variables(v), strict=True)
    pm.eval()
    cache_j = [jm.init_cache_group(b, beam, 10, quantized=True)]
    cache_p = pm.init_cache_group(b, beam, 10, quantized=True)

    def jax_step(ys, pos, anc):
        return jm.apply(v, ys, pos, cache_j[0], anc, beam, method="score_step_anc")

    def port_step(ys, pos, anc):
        with torch.no_grad():
            return pm.score_step_anc(ys, pos, cache_p, anc, beam)

    def jax_write(new_kv, pos):
        cache_j[0] = [jwrite(ck, cv, kn, vn, pos) for (ck, cv), (kn, vn) in zip(cache_j[0], new_kv)]

    def port_write(new_kv, pos):
        for (ck, cv), (kn, vn) in zip(cache_p, new_kv):
            pwrite(ck, cv, kn, vn, pos)

    _walk_beam(jax_step, port_step, jax_write, port_write, 7, b, beam, 16, seed=18)


# ------------------------------------------------------- the whole slice


@pytest.mark.parametrize("conf,atol", [
    ({"cache_dtype": "int8"}, 1e-4),
    ({"mem_dtype": "int8"}, 1e-4),
    ({"cache_dtype": "int8", "mem_dtype": "int8"}, INT8_BOTH_SCORE_ATOL),
    ({"cache_dtype": "int8", "mem_dtype": "int8", "phase_widths": [0.25, 0.5]}, 1e-4),
])
def test_speech2text_nbest_int8_matches_jax(conf, atol):
    """Tiny flagship with a tiny LM, beam 3, nbest 2, the JAX engine on its
    default (XLA) path. With phased widths the request has 48 frames, so
    that one phase of width 32 (the int8 tile) runs before the full width."""
    js, ps, batch = _engines("tiny", LM_TINY, beam_size=3, nbest=2, **conf)
    if "phase_widths" in conf:
        batch = _batch(frames=48)
    assert ps.beam_config.width_tile == (32 if "cache_dtype" in conf else 8)
    _same_nbest(ps.nbest(batch), js.nbest(batch), atol)


def _column_gap(got, want):
    """Median of |got - want| over each (..., dk) column's max |want|."""
    return float(((got - want).abs() / want.abs().amax(-1, keepdim=True).clamp_min(1e-30)).median())


def test_int8_scores_move_by_more_than_1e4_under_the_packages_gap(monkeypatch):
    """The witness behind ``INT8_BOTH_SCORE_ATOL``. The gap: the port's
    decoder projects each package's encoder output to memory K/V, which
    differ by a median of about 3e-7 of a column's max. Relative noise of
    1e-6 on everything the port quantises (memory K/V and each step's
    columns) is no larger than that gap; over three noise seeds it keeps the
    ids and moves a score by more than 1e-4, and by no more than the
    limit."""
    from tailored_avsr_tpu_torch import inference as inf_mod
    from tailored_avsr_tpu_torch.decode import beam_search as bs
    from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column

    js, ps, batch = _engines("tiny", LM_TINY, beam_size=3, nbest=2, cache_dtype="int8", mem_dtype="int8")
    args = tuple(batch[k] for k in ("audio", "audio_lengths", "video", "video_lengths"))
    enc_jax = torch.from_numpy(np.array(js.model.apply(js.variables, *args, method="encode")[0]))
    with torch.no_grad():
        enc_port = ps.model.encode(*(torch.from_numpy(a) for a in args))[0]
        mem_port, mem_jax = (ps.model.decoder.precompute_memory(e) for e in (enc_port, enc_jax))
    gap = min(_column_gap(p, j) for pair_p, pair_j in zip(mem_port, mem_jax) for p, j in zip(pair_p, pair_j))

    base = ps.nbest(batch)
    spread, noise_gap = 0.0, 0.0
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)

        def noisy(x):
            nonlocal noise_gap
            y = x * (1 + 1e-6 * torch.randn(x.shape, generator=gen))
            noise_gap = max(noise_gap, _column_gap(y, x))
            return quantize_kv_column(y)

        monkeypatch.setattr(bs, "quantize_kv_column", noisy)
        monkeypatch.setattr(inf_mod, "quantize_kv_column", noisy)
        got = ps.nbest(batch)
        _same_nbest(got, base, INT8_BOTH_SCORE_ATOL)
        spread = max(spread, max(abs(g[3] - w[3]) for gs, ws in zip(got, base) for g, w in zip(gs, ws)))
    assert 0 < noise_gap <= gap, (noise_gap, gap)
    assert 1e-4 < spread <= INT8_BOTH_SCORE_ATOL, spread


def test_speech2text_nbest_int8_matches_jax_pallas_path(monkeypatch):
    """Both int8 modes with phased widths against the JAX engine through its
    Pallas kernels (K6 and the int8 column writes, interpret mode)."""
    monkeypatch.setenv("TAVSR_FORCE_PALLAS_WRITES", "1")
    js, ps, _ = _engines("tiny", LM_TINY, beam_size=3, nbest=2, cache_dtype="int8", mem_dtype="int8",
                         fused_group_attend=True, phase_widths=[0.25, 0.5])
    batch = _batch(frames=48)
    _same_nbest(ps.nbest(batch), js.nbest(batch), 1e-4)


def test_speech2text_nbest_int8_full_width_matches_jax():
    """Full width, both int8 modes: 12-block encoder, 6-block 256-d decoder,
    16-layer 512-d LM, beam 10; batch 2, 8 frames."""
    js, ps, batch = _engines("full", LM_FULL, beam_size=10, nbest=2, cache_dtype="int8", mem_dtype="int8")
    _same_nbest(ps.nbest(batch), js.nbest(batch), 1e-4)


def _tiny_cfg(**inference_conf):
    cfg = graft._flagship_cfg(tiny=True)
    cfg.token_list = TOKENS
    cfg.inference_conf = dict(cfg.inference_conf, **inference_conf)
    return cfg


@pytest.mark.parametrize("conf,match", [
    ({"cache_dtype": "int8", "cache_protocol": "append"}, "cache_protocol"),
    ({"cache_dtype": "int4"}, "cache_dtype"),
    ({"mem_dtype": "int8", "cache_protocol": "append"}, "mem_dtype"),
    ({"mem_dtype": "int4"}, "mem_dtype"),
])
def test_int8_refusals_match_jax(conf, match):
    """The JAX engine's refusals (``tests/test_fused_beam_ci.py:163-203``),
    with the same messages in both packages."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    with pytest.raises(NotImplementedError, match=match) as jerr:
        JaxSpeech2Text(_tiny_cfg(**conf))
    with pytest.raises(NotImplementedError, match=match) as perr:
        Speech2Text(_tiny_cfg(**conf), device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_cache_dtype_equal_to_the_model_dtype_is_accepted():
    """``cache_dtype: float32`` under the f32 tiny model is a no-op (the
    bfloat16 case needs K4 with mixed types: test_torch_port_beam)."""
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = _tiny_cfg(cache_dtype="float32")
    assert str(getattr(cfg, "dtype", "float32")) == "float32"
    engine = Speech2Text(cfg, device="cpu")
    assert not engine.quantized_cache and engine.beam_config.width_tile == 8


# ------------------------------------------------------------------ P1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_p1_plain_matches_numpy_and_the_tpu_kernel(dtype):
    """``stream_abs_sum`` (its plain version, and the wrapper on CPU
    tensors) against numpy, and its last row against the TPU kernel's
    (1, 1) output, the sum of the last grid step's row (interpret mode)."""
    from tailored_avsr_tpu_torch.ops import stream_probe as sp

    rs = np.random.RandomState(19)
    shape = (3, 2, 3, 5, 64)
    if dtype == "int8":
        x = rs.randint(-128, 128, shape).astype(np.int8)
        px, jx = torch.from_numpy(x), jnp.asarray(x)
    else:
        x32 = rs.randn(*shape).astype(np.float32)
        px, jx = torch.from_numpy(x32).to(TORCH_DTYPES[dtype]), jnp.asarray(x32).astype(jnp.dtype(dtype))
    want = np.abs(px.float().numpy().astype(np.float64)).reshape(shape[0], -1).sum(axis=1)

    def stream_kernel(x_ref, o_ref):  # scripts/bench_int8_stream.py:34
        o_ref[0, 0] = jnp.sum(jnp.abs(x_ref[...].astype(jnp.float32)))

    tpu = pl.pallas_call(
        stream_kernel, grid=(shape[0],),
        in_specs=[pl.BlockSpec((1,) + shape[1:], lambda i: (i,) + (0,) * (len(shape) - 1))],
        out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32), interpret=True,
    )(jx)
    before = sp.stream_abs_sum.launches
    for fn in (sp.stream_abs_sum_plain, sp.stream_abs_sum):
        got = fn(px)
        assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0],)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(float(got[-1]), float(np.asarray(tpu)[0, 0]), rtol=1e-6)
    assert sp.stream_abs_sum.launches == before


def test_p1_probe_cases_are_the_scripts():
    from tailored_avsr_tpu_torch.ops import stream_probe as sp

    cases = sp.probe_cases()
    assert [c[0] for c in cases] == ["bf16_dk64", "int8_dk64", "int8_dk128", "int8_flat"]
    assert [c[1] for c in cases] == [(96, 8, 10, 104, 64), (96, 8, 10, 104, 64), (96, 8, 10, 52, 128),
                                     (96, 8, 10, 6656)]
    assert all(np.prod(c[1]) == np.prod(sp.PROBE_SHAPE) for c in cases)
    with pytest.raises(ValueError, match="card"):
        sp.run_probe("cpu")


# --------------------------------------------------- the port's guards


def _flagship_variables():
    from tailored_avsr_tpu.tasks.avsr import AVSRTask

    cfg = graft._flagship_cfg(tiny=True)
    tokens = [line.rstrip() for line in open(TOKENS) if line.rstrip()]
    batch = _batch()
    args = tuple(batch[k] for k in ("audio", "audio_lengths", "video", "video_lengths"))
    jm = AVSRTask.build_model(cfg, tokens)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)}, *args,
        np.ones((2, 4), np.int32), np.full((2,), 4, np.int32)))
    return _random_variables(shapes, seed=5)


def _lm_variables(lm_conf):
    from tailored_avsr_tpu.tasks.lm import LMTask

    tokens = [line.rstrip() for line in open(TOKENS) if line.rstrip()]
    lm = LMTask.build_model(types.SimpleNamespace(token_list=None, lm_conf=lm_conf), tokens)
    shapes = jax.eval_shape(lambda: lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                            jnp.array([4])))
    return _random_variables(shapes, seed=6)


@pytest.mark.parametrize("which", ["flagship_tiny", "lm_tiny", "lm_full"])
def test_port_export_equals_the_jax_export(which):
    """The port's numpy-only copy of ``export_torch_state_dict`` against the
    JAX package's: the same keys, and each array equal with its dtype."""
    from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict as jexport
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict as pexport

    variables = {"flagship_tiny": _flagship_variables, "lm_tiny": lambda: _lm_variables(LM_TINY),
                 "lm_full": lambda: _lm_variables(LM_FULL)}[which]()
    want, got = jexport(variables), pexport(variables)
    assert list(got) == list(want) and len(got) > 20
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def _port_sources():
    pkg = os.path.join(ROOT, "tailored_avsr_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def _foreign(module: str) -> bool:
    return module.split(".")[0] in ("tailored_avsr_tpu", "jax", "jaxlib", "flax")


def test_port_sources_import_nothing_of_the_jax_package():
    """A static check of every ``.py`` file of the port and of
    ``chip_smoke.py``, lazy imports included: no ``import`` or ``from ...
    import`` of ``tailored_avsr_tpu`` (other than ``tailored_avsr_tpu_torch``),
    JAX or flax, and no ``import_module`` / ``__import__`` of them by name."""
    files = _port_sources()
    assert len(files) > 30
    found = []
    for path in files:
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
                fn = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(node.func, "id", "")
                if fn in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                    names = [node.args[0].value]
            found += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}" for n in names if _foreign(n)]
    assert not found, found


def test_speech2text_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No silent CPU: without ``device=`` the engine takes ``cuda`` and, on a
    host with no CUDA device, refuses; ``device="cpu"`` runs on the CPU."""
    from tailored_avsr_tpu_torch.inference import Speech2Text

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Speech2Text(_tiny_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Speech2Text(_tiny_cfg(), device="cuda")
    assert Speech2Text(_tiny_cfg(), device="cpu").device == torch.device("cpu")


def test_build_model_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The factories behind ``Speech2Text`` follow its rule: without
    ``device=`` they build on ``cuda`` and, on a host with no CUDA device,
    refuse with the same words; ``device="cpu"`` builds on the CPU. The
    config gates come first, so an unported choice still names its item."""
    import types

    from tailored_avsr_tpu_torch.tasks import avsr as avsr_task
    from tailored_avsr_tpu_torch.tasks import lm as lm_task

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tokens = ["<blank>", "a", "<sos/eos>"]
    lm_cfg = types.SimpleNamespace(lm="transformer", lm_conf={"pos_enc": None, "embed_unit": 16,
                                                               "att_unit": 16, "head": 2, "unit": 32,
                                                               "layer": 1})
    for build, cfg in ((avsr_task.build_model, _tiny_cfg()), (lm_task.build_model, lm_cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
            build(cfg, tokens)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg, tokens, device="cuda")
        model = build(cfg, tokens, device="cpu")
        assert {p.device for p in model.parameters()} == {torch.device("cpu")}
    cfg = _tiny_cfg()
    cfg.decoder = "sim_t"
    with pytest.raises(NotImplementedError, match="item 8"):
        avsr_task.build_model(cfg, tokens)
