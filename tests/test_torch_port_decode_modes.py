"""The port's remaining decode modes against the JAX package, in f32 on the CPU.

Modules: the single-query attends of the append and segmented protocols
and ``apply_scores``; the Transformer decoder's four beam steps (the
full-prefix recompute, the cached step that writes its cache, the append
step, the segmented step) and the LM's three, each walked over a beam
with random reorders against its JAX twin and against the port's own
full-prefix recompute; the LM's and the model's ``nll``; the beam-row
permutes; the beam search's LM and n-gram part scorer slots and its
default state gather; the decoder and LM step over a group cache of
another dtype than the model's; the time-synchronous CTC beam (one pass
and chunked, planted ties, a length-0 utterance, B = 1). Then
``Speech2Text.nbest`` against the JAX engine over every cache protocol and
decode mode, and ``stream`` against per-batch calls.

Tolerances: 1e-5 abs per op and step (f32 sums in another order); 1e-4 on
beam and time-sync scores; token ids identical.
"""

import copy
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from test_torch_port_beam import LM_TINY, _batch, _engines, _same_nbest
from test_torch_port_ops import jax_module, load_port, t
from test_torch_port_slice import TOKENS

ATOL = 1e-5


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got),
                               np.asarray(want, np.float32), atol=atol, rtol=0.0)


# --------------------------------------------------------------- attention


def _mha(seed=0, d=32, h=4):
    from tailored_avsr_tpu.ops.attention import MultiHeadedAttention as J
    from tailored_avsr_tpu_torch.ops.attention import MultiHeadedAttention as P

    x = np.random.RandomState(seed).randn(2, 5, d).astype(np.float32)
    jm = J(h, 0.0, d)
    v = jax_module(jm, x, x, x)
    return jm, v, load_port(P(h, 0.0, d), v, "attn")


def test_mha_attend_kv_and_append():
    jm, v, pm = _mha(1)
    rs = np.random.RandomState(2)
    n, lc = 3, 9
    query = rs.randn(n, 1, 32).astype(np.float32)
    k, vv = (rs.randn(n, 4, lc, 8).astype(np.float32) for _ in range(2))
    k_new, v_new = (rs.randn(n, 4, 1, 8).astype(np.float32) for _ in range(2))
    mask = np.arange(lc)[None] < np.array([9, 4, 1])[:, None]
    with torch.no_grad():
        close(pm.attend_kv(t(query), t(k), t(vv), t(mask)), jm.apply(v, query, k, vv, mask, method="attend_kv"))
        got = pm.attend_kv_append(t(query), t(k), t(vv), t(k_new), t(v_new), t(mask))
    close(got, jm.apply(v, query, k, vv, k_new, v_new, mask, method="attend_kv_append"))
    # the append attend is the plain attend over the cache with the column written
    full_k, full_v = (np.concatenate([a, b], axis=2) for a, b in ((k, k_new), (vv, v_new)))
    full_mask = np.concatenate([mask, np.ones((n, 1), bool)], axis=1)
    with torch.no_grad():
        close(got, pm.attend_kv(t(query), t(full_k), t(full_v), t(full_mask)))


@pytest.mark.parametrize("segments", [1, 2, 3, 4])
def test_mha_attend_kv_segmented(segments):
    """The online softmax over segments equals the unsegmented attend
    within 1e-5 in f32 at every live length, including a pos that ends a
    segment, and equals the JAX form (whose skipped segments are lax.cond
    branches)."""
    jm, v, pm = _mha(3)
    rs = np.random.RandomState(4)
    n, lc = 3, 12
    seg = -(-lc // segments)
    query = rs.randn(n, 1, 32).astype(np.float32)
    k, vv = (rs.randn(n, 4, seg * segments, 8).astype(np.float32) for _ in range(2))
    ks = [k[:, :, i * seg:(i + 1) * seg] for i in range(segments)]
    vs = [vv[:, :, i * seg:(i + 1) * seg] for i in range(segments)]
    for pos in sorted({1, 2, seg, seg + 1, lc}):
        mask = np.broadcast_to(np.arange(seg * segments)[None] < pos, (n, seg * segments))
        with torch.no_grad():
            got = pm.attend_kv_segmented(t(query), [t(x) for x in ks], [t(x) for x in vs], pos, seg)
            close(got, pm.attend_kv(t(query), t(k), t(vv), t(np.ascontiguousarray(mask))))
        close(got, jm.apply(v, query, ks, vs, jnp.asarray(pos), seg, method="attend_kv_segmented"))


def test_mha_apply_scores():
    jm, v, pm = _mha(5)
    rs = np.random.RandomState(6)
    values = rs.randn(2, 7, 32).astype(np.float32)
    scores = np.abs(rs.randn(2, 4, 3, 7)).astype(np.float32)
    with torch.no_grad():
        got = pm.apply_scores(t(values), t(scores))
    close(got, jm.apply(v, values, scores, method="apply_scores"))


# ------------------------------------------------- decoder and LM steps


def _walk(steps, n, beam, l, jax_step, port_step, port_full, jax_reorder, port_reorder, seed):
    """Both steppers over ``steps`` beam steps of a token buffer that the
    same random reorders permute; each step's log-probs against the JAX
    twin and against the port's full-prefix recompute of the buffer."""
    rs = np.random.RandomState(seed)
    ys = rs.randint(1, 9, (n, l)).astype(np.int64)
    ys[:, 0] = 10
    for pos in range(1, steps + 1):
        want = jax_step(ys, pos)
        with torch.no_grad():
            got = port_step(torch.from_numpy(ys), pos)
            full = port_full(torch.from_numpy(ys), pos)
        close(got, want)
        close(got, full)
        src_bk = rs.randint(0, beam, (n // beam, beam))
        g_src = (np.arange(n // beam)[:, None] * beam + src_bk).reshape(n)
        jax_reorder(src_bk, g_src, pos)
        with torch.no_grad():
            port_reorder(torch.from_numpy(src_bk), torch.from_numpy(g_src), pos)
        ys = ys[g_src]
        ys[:, pos] = rs.randint(1, 11, n)


def _decoder(seed=6):
    from tailored_avsr_tpu.models.decoder import TransformerDecoder as J
    from tailored_avsr_tpu_torch.models.decoder import TransformerDecoder as P

    rs = np.random.RandomState(seed)
    b, tm, d, vocab = 2, 9, 32, 11
    conf = dict(encoder_output_size=d, attention_heads=4, linear_units=40, num_blocks=2,
                dropout_rate=0.0, positional_dropout_rate=0.0)
    mem = rs.randn(b, tm, d).astype(np.float32)
    mem_mask = np.arange(tm)[None] < np.array([9, 6])[:, None]
    jm = J(vocab, **conf)
    v = jax_module(jm, mem, mem_mask, rs.randint(0, vocab, (b, 5)).astype(np.int32), np.array([5, 3], np.int32))
    return jm, v, load_port(P(vocab, **conf), v, "decoder"), mem, mem_mask


@pytest.mark.parametrize("protocol", ["full", "cached", "append", "seg2", "seg3"])
def test_decoder_steps_match_jax_and_the_full_prefix(protocol):
    """Each decoder beam step over 7 steps (beam 3, batch 2): the full-prefix
    ``score_step``, ``score_step_cached`` reordered by ``reorder_beam_rows``,
    ``score_step_append`` written by ``insert_permute_rows`` and
    ``score_step_cached_seg`` in 2 and 3 segments reordered by
    ``gather_cache_seg``."""
    jbs = importlib.import_module("tailored_avsr_tpu.decode.beam_search")
    from tailored_avsr_tpu.models.decoder import TransformerDecoder as J
    from tailored_avsr_tpu_torch.decode import beam_search as pbs
    from tailored_avsr_tpu_torch.models.decoder import TransformerDecoder as P

    jm, v, pm, mem, mem_mask = _decoder()
    beam, steps, lc = 3, 7, 9
    n = 2 * beam
    mem_r, mm_r = np.repeat(mem, beam, 0), np.repeat(mem_mask, beam, 0)
    mem_kv_j = jm.apply(v, mem_r, method="precompute_memory")
    with torch.no_grad():
        mem_kv_p = pm.precompute_memory(t(mem_r))
    segs = int(protocol[3:]) if protocol.startswith("seg") else 0
    if segs:
        st = {"j": jm.init_cache_seg(n, lc, num_segments=segs), "p": pm.init_cache_seg(n, lc, num_segments=segs)}
    else:
        st = {"j": jm.init_cache(n, lc), "p": pm.init_cache(n, lc)}
    method = {"full": None, "cached": "score_step_cached", "append": "score_step_append"}.get(
        protocol, "score_step_cached_seg")

    def full_p(ys, pos):
        return pm.score_step(t(mem_r), t(mm_r), ys, pos)

    full_j = jax.jit(lambda ys, pos: jm.apply(v, mem_r, mm_r, ys, pos, method="score_step"))
    step_j = jax.jit(lambda ys, pos, cache: jm.apply(v, mem_kv_j, mm_r, ys, pos, cache, method=method))
    insert_j = jax.jit(jbs.insert_permute_rows)
    gather_j = jax.jit(J.gather_cache_seg)

    def jax_step(ys, pos):  # jitted once: op by op, each lax.cond of the segments compiles
        if method is None:
            return full_j(ys, jnp.asarray(pos))
        lp, st["jn"] = step_j(ys, jnp.asarray(pos), st["j"])
        return lp

    def port_step(ys, pos):
        if method is None:
            return pm.score_step(t(mem_r), t(mm_r), ys, pos)
        lp, st["pn"] = getattr(pm, method)(mem_kv_p, t(mm_r), ys, pos, st["p"])
        return lp

    def jax_reorder(src_bk, g_src, pos):
        if protocol == "append":
            st["j"] = [(insert_j(ck, kn, jnp.asarray(src_bk), jnp.asarray(pos)),
                        insert_j(cv, vn, jnp.asarray(src_bk), jnp.asarray(pos)))
                       for (ck, cv), (kn, vn) in zip(st["j"], st["jn"])]
        elif segs:
            st["j"] = gather_j(st["jn"], jnp.asarray(g_src), jnp.asarray(pos))
        elif method:
            st["j"] = jax.tree_util.tree_map(lambda x: jbs.reorder_beam_rows(x, jnp.asarray(src_bk)), st["jn"])

    def port_reorder(src_bk, g_src, pos):
        if protocol == "append":
            st["p"] = [(pbs.insert_permute_rows(ck, kn, src_bk, pos), pbs.insert_permute_rows(cv, vn, src_bk, pos))
                       for (ck, cv), (kn, vn) in zip(st["p"], st["pn"])]
        elif segs:
            st["p"] = P.gather_cache_seg(st["pn"], g_src, pos)
        elif method:
            st["p"] = [tuple(pbs.reorder_beam_rows(x, src_bk) for x in layer) for layer in st["pn"]]

    _walk(steps, n, beam, steps + 2, jax_step, port_step, full_p, jax_reorder, port_reorder, seed=11)
    if method is not None and protocol != "append":
        flat = lambda c: [x for layer in c for side in layer for x in (side if isinstance(side, tuple) else (side,))]  # noqa: E731
        for g, w in zip(flat(st["p"]), flat(st["j"])):
            close(g, w)


def _lm(embed_unit, pos_enc, seed=8):
    from tailored_avsr_tpu.models.lm import TransformerLM as J
    from tailored_avsr_tpu_torch.models.lm import TransformerLM as P
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_lm_variables

    rs = np.random.RandomState(seed)
    vocab = 11
    conf = dict(att_unit=32, head=4, unit=40, layer=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                embed_unit=embed_unit, pos_enc=pos_enc)
    jm = J(vocab, **conf)
    v = jax_module(jm, rs.randint(0, vocab, (2, 6)).astype(np.int32), np.array([6, 4], np.int32))
    pm = P(vocab, **conf)
    pm.load_state_dict(convert_jax_lm_variables(v), strict=True)
    return jm, v, pm.eval()


@pytest.mark.parametrize("protocol", ["full", "cached", "append"])
@pytest.mark.parametrize("embed_unit,pos_enc", [(16, None), (None, "sinusoidal")])
def test_lm_steps_match_jax_and_the_full_prefix(protocol, embed_unit, pos_enc):
    jbs = importlib.import_module("tailored_avsr_tpu.decode.beam_search")
    from tailored_avsr_tpu_torch.decode import beam_search as pbs

    jm, v, pm = _lm(embed_unit, pos_enc)
    beam, steps, lc = 3, 7, 9
    n = 2 * beam
    st = {"j": jm.init_cache(n, lc), "p": pm.init_cache(n, lc)}
    method = {"full": None, "cached": "score_step_cached", "append": "score_step_append"}[protocol]

    full_j = jax.jit(lambda ys, pos: jm.apply(v, ys, pos, method="score_step"))
    step_j = jax.jit(lambda ys, pos, cache: jm.apply(v, ys, pos, cache, method=method))
    insert_j = jax.jit(jbs.insert_permute_rows)

    def jax_step(ys, pos):
        if method is None:
            return full_j(ys, jnp.asarray(pos))
        lp, st["jn"] = step_j(ys, jnp.asarray(pos), st["j"])
        return lp

    def port_step(ys, pos):
        if method is None:
            return pm.score_step(ys, pos)
        lp, st["pn"] = getattr(pm, method)(ys, pos, st["p"])
        return lp

    def jax_reorder(src_bk, g_src, pos):
        if protocol == "append":
            st["j"] = [(insert_j(ck, kn, jnp.asarray(src_bk), jnp.asarray(pos)),
                        insert_j(cv, vn, jnp.asarray(src_bk), jnp.asarray(pos)))
                       for (ck, cv), (kn, vn) in zip(st["j"], st["jn"])]
        elif method:
            st["j"] = jax.tree_util.tree_map(lambda x: jbs.reorder_beam_rows(x, jnp.asarray(src_bk)), st["jn"])

    def port_reorder(src_bk, g_src, pos):
        if protocol == "append":
            st["p"] = [(pbs.insert_permute_rows(ck, kn, src_bk, pos), pbs.insert_permute_rows(cv, vn, src_bk, pos))
                       for (ck, cv), (kn, vn) in zip(st["p"], st["pn"])]
        elif method:
            st["p"] = [tuple(pbs.reorder_beam_rows(x, src_bk) for x in layer) for layer in st["pn"]]

    _walk(steps, n, beam, steps + 2, jax_step, port_step, pm.score_step, jax_reorder, port_reorder, seed=12)


def _dequantized_port(model, v):
    """A port model of f32 weights loaded from JAX variables (dequantised)."""
    from tailored_avsr_tpu_torch.models.decoder import TransformerDecoder as P
    from tailored_avsr_tpu_torch.models.lm import TransformerLM as PL
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_lm_variables

    v = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), v)
    if model == "decoder":
        return load_port(P(11, encoder_output_size=32, attention_heads=4, linear_units=40, num_blocks=2), v,
                         "decoder")
    pm = PL(11, att_unit=32, head=4, unit=40, layer=2, embed_unit=16)
    pm.load_state_dict(convert_jax_lm_variables(v), strict=True)
    return pm


@pytest.mark.parametrize("quantize", [None, "qint8", "bfloat16"], ids=["plain", "qint8", "bf16_weights"])
@pytest.mark.parametrize("model", ["decoder", "lm"])
def test_step_over_a_group_cache_of_another_dtype(model, quantize):
    """A bf16 model over an f32 group cache (``cache_dtype: float32``): the
    first self-attention returns f32 and the rest of the step runs in f32
    on the bf16 weights, as flax promotes; an f32 model over a bf16 cache
    rounds the attend where the JAX XLA form rounds (within 1e-5 of the JAX
    step). The step's columns come back in the JAX step's dtypes. The bf16
    model's log-probs carry bf16 roundings made in another order before the
    first attend (the two packages' all-bf16 steps differ by ~2e-2), so
    they are held to be nearer the JAX step over the f32 cache than to the
    JAX step over the same values in a bf16 cache, which keeps the stream
    in bf16.

    With quantised weights (``quantize_min_size`` 256) the JAX variables go
    through ``quantize_variables`` and its step dequantises them, and the
    port's step runs as the engine runs it: quantised outside inference
    mode, stepped under ``torch.inference_mode()`` and
    ``parametrize.cached()``. The f32 copy of the bf16 model then holds
    exactly the JAX package's dequantised weights (int8 payload x scale
    rounded to bf16; the bf16 payload as it is) widened to f32. The
    quantised cases take the bf16 model over the f32 cache only: under an
    f32 model a bf16-stored embedding's x * sqrt(d) is rounded to bf16 in
    this jitted JAX step (3.4e-3 on the decoder's log-probs) and not in the
    JAX engine's decode graph, which XLA's excess precision decides."""
    from torch.nn.utils import parametrize

    from tailored_avsr_tpu.utils.quantize import dequantize_variables, quantize_variables
    from tailored_avsr_tpu_torch.models.decoder import widened
    from tailored_avsr_tpu_torch.utils.quantize import quantize_model

    rs = np.random.RandomState(13)
    beam, b, lc, pos = 3, 2, 16, 6
    n = b * beam
    pairs = ((jnp.bfloat16, jnp.float32), (jnp.float32, jnp.bfloat16))
    for model_dt, cache_dt in pairs[:1] if quantize else pairs:
        if model == "decoder":
            jm, v, pm, mem, mem_mask = _decoder()
        else:
            jm, v, pm = _lm(16, None)
        v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, model_dt), v)
        pm.to(torch.bfloat16 if model_dt == jnp.bfloat16 else torch.float32)
        if quantize:
            v = quantize_variables(v, quantize, min_size=256)
            assert quantize_model(pm, quantize, 256)
        tdt = torch.bfloat16 if cache_dt == jnp.bfloat16 else torch.float32
        values = [tuple(jnp.asarray(jnp.asarray(rs.randn(b, 4, beam, lc, 8), jnp.bfloat16), jnp.float32)
                        for _ in range(2)) for _ in range(2)]  # bf16 values: exact in either cache
        anc = rs.randint(0, beam, (n, lc)).astype(np.int32)
        ys = rs.randint(1, 9, (n, 9)).astype(np.int32)

        @jax.jit
        def jstep(v, cache):
            v = dequantize_variables(v)
            if model == "decoder":
                mem_kv = jm.apply(v, jnp.asarray(mem, model_dt), method="precompute_memory")
                return jm.apply(v, mem_kv, mem_mask, ys, jnp.asarray(pos), cache, anc, beam,
                                method="score_step_anc")
            return jm.apply(v, ys, jnp.asarray(pos), cache, anc, beam, method="score_step_anc")

        def jax_step(dt, v=v, jstep=jstep):
            return jstep(v, [tuple(x.astype(dt) for x in layer) for layer in values])

        want, new_j = jax_step(cache_dt)
        cache_p = [tuple(torch.from_numpy(np.array(x)).to(tdt) for x in layer) for layer in values]
        with torch.inference_mode(), parametrize.cached():
            if model == "decoder":
                mem_kv_p = pm.precompute_memory(t(mem).to(pm.dtype))
                got, new_p = pm.score_step_anc(mem_kv_p, t(mem_mask), t(ys).long(), pos, cache_p, t(anc), beam)
            else:
                got, new_p = pm.score_step_anc(t(ys).long(), pos, cache_p, t(anc), beam)
        assert got.dtype == torch.float32
        for (gk, gv), (wk, wv) in zip(new_p, new_j):
            assert str(gk.dtype).split(".")[-1] == str(wk.dtype) and gv.dtype == gk.dtype
        if model_dt == jnp.float32:
            close(got, want)
        else:
            err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
            other = np.abs(got.numpy() - np.asarray(jax_step(jnp.bfloat16)[0], np.float32)).max()
            assert err < other, (err, other)
            if quantize:
                twin, ref = dict(widened(pm, torch.float32).named_modules()), _dequantized_port(
                    model, dequantize_variables(v))
                picked = [name for name, m in pm.named_modules() if parametrize.is_parametrized(m, "weight")]
                assert picked
                for name in picked:
                    assert torch.equal(twin[name].weight, ref.get_submodule(name).weight), name


@pytest.mark.parametrize("quantize", ["qint8", "bfloat16"])
def test_bf16_model_over_an_f32_cache_decodes_with_quantised_weights(quantize):
    """The engine with a bf16 model, ``cache_dtype: float32`` and both the
    model and the LM quantised (``quantize_min_size`` 256): weights are
    quantised outside inference mode and the f32 copy of each model is made
    from its payloads, so the call decodes (the JAX engine decodes this
    case); the n-best lists are whole and finite."""
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = graft._flagship_cfg(tiny=True)
    cfg.token_list, cfg.dtype = TOKENS, "bfloat16"
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=3, nbest=2, unroll=1, cache_dtype="float32",
                              quantize_asr_model=True, quantize_lm=True, quantize_dtype=quantize,
                              quantize_min_size=256)
    lm_cfg = types.SimpleNamespace(token_list=None, lm_conf=LM_TINY)
    ps = Speech2Text(cfg, lm_config=lm_cfg, device="cpu")
    got = ps.nbest(_batch())
    assert [len(h) for h in got] == [2, 2]
    assert all(np.isfinite(h[0][3]) and h[0][3] > -1e9 for h in got)
    assert ps.nbest(_batch()) == got  # the kept f32 copies serve the next call alike


def test_lm_nll_matches_jax():
    jm, v, pm = _lm(16, None)
    rs = np.random.RandomState(14)
    tokens = rs.randint(0, 10, (3, 6)).astype(np.int32)
    lens = np.array([6, 3, 0], np.int32)
    tokens[np.arange(6)[None] >= lens[:, None]] = -1
    want, want_n = jm.apply(v, tokens, lens, method="nll")
    with torch.no_grad():
        got, got_n = pm.nll(t(tokens).long(), t(lens).long())
    close(got, want)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_model_nll_and_decoder_score_step_match_jax():
    """The tiny flagship's ``nll`` (the time-sync rescoring pass) and
    ``decoder_score_step`` on random encoder output."""
    js, ps, _ = _engines("tiny", None)
    rs = np.random.RandomState(15)
    d = ps.model.decoder.after_norm.weight.shape[0]
    enc = rs.randn(3, 7, d).astype(np.float32)
    lens = np.array([7, 5, 2], np.int32)
    ys = rs.randint(1, 30, (3, 5)).astype(np.int32)
    ys_lens = np.array([5, 2, 0], np.int32)
    ys[np.arange(5)[None] >= ys_lens[:, None]] = -1
    want = jax.jit(lambda *a: js.model.apply(js.variables, *a, method="nll"))(enc, lens, ys, ys_lens)
    with torch.no_grad():
        got = ps.model.nll(t(enc), t(lens).long(), t(ys).long(), t(ys_lens).long())
    close(got, want)
    mask = np.arange(7)[None] < lens[:, None]
    buf = np.abs(ys).astype(np.int32)
    want = jax.jit(lambda *a: js.model.apply(js.variables, *a, method="decoder_score_step"))(
        enc, mask, buf, jnp.asarray(3))
    with torch.no_grad():
        close(ps.model.decoder_score_step(t(enc), t(mask), t(buf).long(), 3), want)


# -------------------------------------------------------- beam helpers


def test_beam_row_permutes_are_exact():
    jbs = importlib.import_module("tailored_avsr_tpu.decode.beam_search")
    from tailored_avsr_tpu_torch.decode import beam_search as pbs

    rs = np.random.RandomState(16)
    b, k, h, lc, dk = 2, 3, 2, 5, 4
    x = rs.randn(b * k, h, lc, dk).astype(np.float32)
    col = rs.randn(b * k, h, 1, dk).astype(np.float32)
    src = rs.randint(0, k, (b, k))
    np.testing.assert_array_equal(pbs.reorder_beam_rows(t(x), t(src)).numpy(),
                                  np.asarray(jbs.reorder_beam_rows(jnp.asarray(x), jnp.asarray(src))))
    for dt in (np.float32, jnp.bfloat16):  # the column is cast to the cache's dtype
        xd = np.asarray(jnp.asarray(x, dt))
        got = pbs.insert_permute_rows(t(xd.astype(np.float32)).to(torch.bfloat16 if dt != np.float32 else torch.float32),
                                      t(col), t(src), 3)
        want = jbs.insert_permute_rows(jnp.asarray(xd), jnp.asarray(col), jnp.asarray(src), jnp.asarray(3))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


V, SOS = 7, 6


def _synthetic(seed):
    rs = np.random.RandomState(seed)
    ctc_logp = np.asarray(jax.nn.log_softmax(jnp.asarray(rs.randn(2, 6, V) * 1.5), axis=-1))
    w, u = rs.randn(V, V).astype(np.float32) * 1.2, rs.randn(8, V).astype(np.float32)
    lm_w = rs.randn(V, V).astype(np.float32)
    return ctc_logp, np.array([6, 5], np.int32), w, u, lm_w


@pytest.mark.parametrize("cfg", [
    dict(beam_size=3, ctc_weight=0.4, lm_weight=0.5, penalty=0.1, nbest=2),
    dict(beam_size=3, ctc_weight=1.0, lm_weight=0.7, nbest=2),
    dict(beam_size=3, ctc_weight=0.3, ngram_weight=0.6, nbest=3),
])
def test_beam_search_lm_and_part_scorer_slots(cfg):
    """The stateless LM slot (``lm_score_fn``, as the full-prefix LM and the
    n-gram alone ride it), including at ``ctc_weight: 1.0``, and the part
    scorer on the pre-beam candidates, on synthetic scorers."""
    from tailored_avsr_tpu.decode.beam_search import BeamSearchConfig as JC, beam_search as jbeam
    from tailored_avsr_tpu_torch.decode.beam_search import BeamSearchConfig as PC, beam_search as pbeam

    ctc_logp, lens, w, u, lm_w = _synthetic(17)

    def jatt(ys, pos):
        tok = ys[:, jnp.clip(pos - 1, 0, ys.shape[1] - 1)]
        return jax.nn.log_softmax(jnp.asarray(w)[tok] + jnp.asarray(u)[jnp.minimum(pos, 7)], axis=-1)

    def patt(ys, pos):
        tok = ys[:, min(max(pos - 1, 0), ys.shape[1] - 1)]
        return torch.log_softmax(t(w)[tok] + t(u)[min(pos, 7)], dim=-1)

    def jlm(ys, pos):
        return jax.nn.log_softmax(jnp.asarray(lm_w)[ys[:, jnp.clip(pos - 1, 0, ys.shape[1] - 1)]], axis=-1)

    def plm(ys, pos):
        return torch.log_softmax(t(lm_w)[ys[:, min(max(pos - 1, 0), ys.shape[1] - 1)]], dim=-1)

    part = "ngram_weight" in cfg
    kw_j = {"ngram_part_fn": lambda ys, pos, c: jnp.take_along_axis(jlm(ys, pos), c, axis=1)} if part else \
        {"lm_score_fn": jlm}
    kw_p = {"ngram_part_fn": lambda ys, pos, c: torch.gather(plm(ys, pos), 1, c)} if part else {"lm_score_fn": plm}
    want = jbeam(jatt, jnp.asarray(ctc_logp), jnp.asarray(lens), SOS, SOS, JC(**cfg), **kw_j)
    got = pbeam(patt, t(ctc_logp), t(lens), SOS, SOS, PC(**cfg), **kw_p)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    close(got.scores, want.scores, atol=1e-4)


def test_beam_search_default_state_gather():
    """A stateful scorer without ``att_gather_fn``: every tensor of its
    state follows the reorder by rows (the JAX tree_map of
    ``reorder_beam_rows``). The state is the running sum of the tokens."""
    from tailored_avsr_tpu.decode.beam_search import BeamSearchConfig as JC, beam_search as jbeam
    from tailored_avsr_tpu_torch.decode.beam_search import BeamSearchConfig as PC, beam_search as pbeam

    ctc_logp, lens, w, u, _ = _synthetic(18)
    cfg = dict(beam_size=3, ctc_weight=0.3, nbest=2)

    def jatt(ys, pos, st):
        tok = ys[:, jnp.clip(pos - 1, 0, ys.shape[1] - 1)]
        s = {"sum": st["sum"] + tok, "rows": (st["rows"][0] + 1,)}
        return jax.nn.log_softmax(jnp.asarray(w)[tok] + 0.1 * s["sum"][:, None], axis=-1), s

    def patt(ys, pos, st):
        tok = ys[:, min(max(pos - 1, 0), ys.shape[1] - 1)]
        s = {"sum": st["sum"] + tok, "rows": (st["rows"][0] + 1,)}
        return torch.log_softmax(t(w)[tok] + 0.1 * s["sum"][:, None].float(), dim=-1), s

    n = 2 * cfg["beam_size"]
    want = jbeam(jatt, jnp.asarray(ctc_logp), jnp.asarray(lens), SOS, SOS, JC(**cfg),
                 att_state={"sum": jnp.zeros(n, jnp.int32), "rows": (jnp.zeros(n),)})
    got = pbeam(patt, t(ctc_logp), t(lens), SOS, SOS, PC(**cfg),
                att_state={"sum": torch.zeros(n, dtype=torch.long), "rows": (torch.zeros(n),)})
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    close(got.scores, want.scores, atol=1e-4)


# ------------------------------------------------------------ time-sync


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test (the suite runs in several processes;
    the engine tests run the ResNet trunk)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _timesync_case(case):
    """(log-probs (B, T, V), lengths): random, or with planted ties (integer
    logits: equal log-probs within a frame and equal prefix scores), with a
    length-0 utterance, or B = 1."""
    rs = np.random.RandomState({"random": 19, "ties": 20, "empty": 21, "single": 22}[case])
    b, tt, v = (1 if case == "single" else 3), 7, 6
    logits = rs.randint(0, 3, (b, tt, v)).astype(np.float32) if case == "ties" else rs.randn(b, tt, v) * 2.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32), axis=-1))
    lens = {"random": [7, 5, 3], "ties": [7, 7, 4], "empty": [7, 0, 5], "single": [6]}[case]
    return lp, np.array(lens, np.int32)


@pytest.mark.parametrize("case", ["random", "ties", "empty", "single"])
def test_timesync_search_matches_jax(case):
    """Tokens and lengths identical, scores and CTC scores within 1e-4, with
    a per-token bonus and an n-gram-like scorer in the loop; a length-0
    utterance gives the empty prefix (score 0)."""
    from tailored_avsr_tpu.decode.ctc_timesync import ctc_timesync_beam_search as jsearch
    from tailored_avsr_tpu_torch.decode.ctc_timesync import ctc_timesync_beam_search as psearch

    lp, lens = _timesync_case(case)
    v = lp.shape[-1]
    table = np.asarray(jax.nn.log_softmax(jnp.asarray(np.random.RandomState(23).randn(v, v)), axis=-1))

    def jng(tokens, lengths, cand):
        last = jnp.take_along_axis(tokens, jnp.clip(lengths - 1, 0)[:, None], axis=1)[:, 0]
        return jnp.asarray(table)[jnp.where(lengths > 0, last, 0), cand]

    def png(tokens, lengths, cand):
        last = torch.gather(tokens, 1, torch.clamp(lengths - 1, min=0)[:, None])[:, 0]
        return t(table)[torch.where(lengths > 0, last, 0), cand]

    kw = dict(beam_size=4, pre_beam=3, max_len=8, penalty=0.3)
    for jkw, pkw in (({}, {}), ({"ngram_scorer": jng, "ngram_weight": 0.5}, {"ngram_scorer": png, "ngram_weight": 0.5})):
        want = jsearch(jnp.asarray(lp), jnp.asarray(lens), **kw, **jkw)
        got = psearch(t(lp), t(lens), **kw, **pkw)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got[2:], want[2:]):
            close(g, w, atol=1e-4)
    if case == "empty":
        assert int(got[1][1, 0]) == 0 and float(got[2][1, 0]) == 0.0


def test_timesync_chunks_chain_to_one_pass():
    """Chunk after chunk (3 + 1 + 3 frames, each chunk's valid lengths)
    equals one pass, state for state, and equals the JAX chunked search."""
    from tailored_avsr_tpu.decode import ctc_timesync as jts
    from tailored_avsr_tpu_torch.decode import ctc_timesync as pts

    lp, lens = _timesync_case("random")
    kw = dict(beam_size=4, pre_beam=3)
    one = pts.ctc_timesync_beam_search(t(lp), t(lens), max_len=8, **kw)
    state_p = pts.timesync_init_state(3, 4, 8)
    state_j = jts.timesync_init_state(3, 4, 8)
    for lo, hi in ((0, 3), (3, 4), (4, 7)):
        valid = np.clip(lens - lo, 0, hi - lo).astype(np.int32)
        state_p = pts.ctc_timesync_chunk(t(lp[:, lo:hi]), t(valid), state_p, **kw)
        state_j = jts.ctc_timesync_chunk(jnp.asarray(lp[:, lo:hi]), jnp.asarray(valid), state_j, **kw)
        for g, w in zip(state_p, state_j):
            close(g, w, atol=1e-4) if g.is_floating_point() else np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(pts.timesync_best(state_p), one):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ------------------------------------------------------ the whole engine


def _asr_engines(ctc_only: bool, lm: bool, **inference_conf):
    """A JAX and a port ``Speech2Text`` of the tiny ASR Branchformer on the
    same random weights (``ctc_only``: model_conf ctc_weight 1.0, no
    decoder), with a tiny LM."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu.tasks.lm import LMTask
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_lm_variables, convert_jax_variables
    from test_torch_port_branchformer import ASR, TOKEN_LIST, speech_batch, tiny_cfg
    from test_torch_port_slice import _random_variables

    cfg = tiny_cfg(ASR)
    if ctc_only:
        cfg.model_conf = dict(cfg.model_conf, ctc_weight=1.0)
    cfg.inference_conf = dict(cfg.inference_conf, **inference_conf)
    b = speech_batch("asr")
    jm = ASRTask.build_model(cfg, list(TOKEN_LIST))
    variables = _random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)}, b["speech"], b["speech_lengths"],
        b["text"], b["text_lengths"])), seed=11)
    lm_cfg = types.SimpleNamespace(token_list=None, lm_conf=LM_TINY) if lm else None
    js = JaxSpeech2Text(copy.deepcopy(cfg), lm_config=lm_cfg)
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ps = Speech2Text(copy.deepcopy(cfg), lm_config=lm_cfg, device="cpu")
    sd, dropped = convert_jax_variables(variables, ps.model)
    assert dropped == [] and (ps.model.decoder is None) == ctc_only
    ps.model.load_state_dict(sd, strict=True)
    if lm:
        lmj = LMTask.build_model(lm_cfg, TOKEN_LIST)
        lm_vars = _random_variables(jax.eval_shape(
            lambda: lmj.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.array([4]))), seed=4)
        js.lm_variables = jax.tree_util.tree_map(jnp.asarray, lm_vars)
        ps.lm.load_state_dict(convert_jax_lm_variables(lm_vars), strict=True)
    return js, ps, {k: b[k] for k in ("speech", "speech_lengths")}


NBEST_MODES = {
    "append_lm": ("avsr", True, {"cache_protocol": "append"}),
    "append_decoder": ("avsr", False, {"cache_protocol": "append"}),
    "segments2_lm": ("avsr", True, {"cache_segments": 2}),
    "segments3_decoder": ("avsr", False, {"cache_segments": 3}),
    "cache_bf16_under_f32": ("avsr", True, {"cache_dtype": "bfloat16"}),
    "timesync_avsr": ("avsr", True, {"decode_mode": "timesync", "penalty": 0.2}),
    "timesync_asr": ("asr", True, {"time_sync": True}),
    "ctc_only_asr": ("ctc_only", True, {"lm_weight": 0.3}),
    "ctc_weight_1_lm": ("avsr", True, {"ctc_weight": 1.0}),
}


@pytest.mark.parametrize("mode", list(NBEST_MODES))
def test_speech2text_nbest_modes_match_jax(mode):
    """``Speech2Text.nbest`` of both packages on the same weights (beam 3,
    nbest 2, the tiny LM where named): ids identical, scores within 1e-4.
    The append and segmented protocols (with the LM folded in, and the
    decoder alone), a bf16 group cache under the f32 model (the plain mixed
    group attend), the time-sync beam with decoder and LM rescoring on AVSR
    and ASR (``time_sync: true``), a CTC-only ASR model (which always takes
    it), and ``ctc_weight: 1.0`` with the LM scoring each full prefix.
    The JAX engine runs one beam step a loop body (``unroll: 1``, which
    the JAX package holds result-exact; the port ignores the key). The
    bf16 cache's scores are held within 1e-3: each step's f32 columns
    (equal to ~1e-7 in the two packages) round to bf16, and a value that
    close to a rounding boundary lands one bf16 step (2^-8 relative) apart,
    which later steps' log-probs carry (3.6e-4 measured on scores of -30)."""
    kind, lm, conf = NBEST_MODES[mode]
    conf = dict({"beam_size": 3, "nbest": 2, "unroll": 1}, **conf)  # one step a JAX loop body: compiles faster
    if kind == "avsr":
        js, ps, batch = _engines("tiny", LM_TINY if lm else None, **conf)
    else:
        js, ps, batch = _asr_engines(kind == "ctc_only", lm, **conf)
    if mode == "cache_bf16_under_f32":  # the tiny config's decoder and LM: dk 16, the plain form
        assert ps.cache_dtype == torch.bfloat16 and ps.dtype == torch.float32
    _same_nbest(ps.nbest(batch), js.nbest(batch), atol=1e-3 if mode == "cache_bf16_under_f32" else 1e-4)


def test_device_normalize_and_stream_match():
    """``device_normalize``: float audio uploads as int16 (the JAX engine's
    clip and cast) and decodes to the JAX engine's n-best; ``stream`` over
    three batches gives the per-batch ``nbest`` and ``__call__`` results
    and passes the host keys through."""
    js, ps, batch = _engines("tiny", None, beam_size=3, nbest=2, unroll=1, device_normalize=True)
    put_j, put_p = js.device_put_batch(batch), ps.device_put_batch(batch)
    assert put_p["audio"].dtype == torch.int16
    np.testing.assert_array_equal(put_p["audio"].numpy(), np.asarray(put_j["audio"]))
    np.testing.assert_array_equal(put_p["video"].numpy(), np.asarray(put_j["video"]))
    _same_nbest(ps.nbest(put_p), js.nbest(put_j))
    rs = np.random.RandomState(24)
    batches = [dict(batch, refs=[f"r{i}", "x"]) for i in range(3)]
    batches[1] = dict(batches[1], audio=(batch["audio"] + 0.01 * rs.randn(*batch["audio"].shape)).astype(np.float32))
    for nbest in (True, False):
        streamed = list(ps.stream(batches, nbest=nbest))
        assert [c["refs"] for c, _ in streamed] == [b["refs"] for b in batches]
        for (cur, got), b in zip(streamed, batches):
            assert cur["audio"].dtype == torch.int16
            assert got == (ps.nbest(ps.device_put_batch(b)) if nbest else ps(ps.device_put_batch(b)))
    assert list(ps.stream([])) == []
