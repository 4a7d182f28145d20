"""The port's Mask-CTC against the JAX package, in f32 on the CPU: the MLM
decoder, the CTC collapse and ``maskctc_decode`` (planted equal-confidence
ties, a length-0 utterance, B = 1, fewer masks than rounds), the MLM loss
and every gradient of the model's loss given the same masked targets, the
uniform masking by its statistics, and ``Speech2Text.nbest`` of a tiny
tailored AVSR and a tiny Branchformer ASR Mask-CTC model.

Weights come from the JAX init (perturbed) or ``_random_variables`` and
load through the key-grammar export (the V + 1 decoder embedding and
output layer among them) with a strict load. Tolerances: decoder logits
1e-5 abs; ids identical; losses 1e-5 relative; gradients within 1e-4 of
their tensor's largest JAX entry plus 1e-5 of the model's largest. The
masking draws of the two packages differ (torch and JAX generators), so
``mask_uniform`` is held to its distribution: each masked count and
position frequency within 5 standard errors of its exact value in both
packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
from test_torch_port_branchformer import ASR, TOKEN_LIST, speech_batch, tiny_cfg
from test_torch_port_ops import jax_module, load_port
from test_torch_port_slice import _batch, _random_variables

MASKCTC = "configs/AVSR/tailored_maskctc_spanish.yaml"
TINY_ATTN = dict(acoustic_use_attn=[False, True], visual_use_attn=[True, False])


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_mlm_decoder_matches_jax():
    """Full self-attention among each sequence's valid tokens: logits within
    1e-5 on valid rows, a V + 1 output layer."""
    from tailored_avsr_tpu.models.decoder import MLMDecoder as J
    from tailored_avsr_tpu_torch.models.decoder import MLMDecoder as P

    rs = np.random.RandomState(3)
    b, tm, d, vocab = 3, 9, 32, 12
    conf = dict(encoder_output_size=d, attention_heads=4, linear_units=40, num_blocks=2, dropout_rate=0.0,
                positional_dropout_rate=0.0)
    mem = rs.randn(b, tm, d).astype(np.float32)
    mem_mask = np.arange(tm)[None] < np.array([9, 6, 2])[:, None]
    ys = rs.randint(0, vocab, (b, 6)).astype(np.int32)
    ys_lens = np.array([6, 3, 1], np.int32)
    jm = J(vocab, **conf)
    v = jax_module(jm, mem, mem_mask, ys, ys_lens)
    pm = load_port(P(vocab, **conf), v, "decoder")
    want = np.asarray(jm.apply(v, mem, mem_mask, ys, ys_lens))
    with torch.no_grad():
        got = pm(t(mem), t(mem_mask), t(ys).long(), t(ys_lens)).numpy()
    assert got.shape == (b, 6, vocab)
    for i, n in enumerate(ys_lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=1e-5)
    # a later token changes the first position's logits: the attention is not causal
    ys2 = ys.copy()
    ys2[0, 4] = (ys2[0, 4] + 1) % vocab
    with torch.no_grad():
        got2 = pm(t(mem), t(mem_mask), t(ys2).long(), t(ys_lens)).numpy()
    assert np.abs(got2[0, 0] - got[0, 0]).max() > 1e-4


def _ctc_case(seed, lengths, t_max=12, v=7):
    """CTC log-probs with runs of repeated ids and blanks, planted equal
    segment maxima, and posteriors on both sides of 0.9."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    ids = rs.randint(0, v, (b, t_max))
    ids[:, 1::3] = ids[:, 0::3][:, :ids[:, 1::3].shape[1]]  # repeats
    peak = rs.uniform(0.5, 0.99, (b, t_max)).astype(np.float32)
    peak[:, 2] = peak[:, 5] = 0.75  # equal posteriors in two segments
    probs = np.full((b, t_max, v), 0.0, np.float32)
    probs += ((1.0 - peak) / (v - 1))[..., None]
    np.put_along_axis(probs, ids[..., None], peak[..., None], axis=-1)
    return np.log(probs).astype(np.float32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths", [(12, 7, 0), (9,)], ids=["with_empty", "b1"])
def test_collapse_matches_jax(lengths):
    """Packed ids, segment-max posteriors and counts equal; the length-0
    utterance gives 0 tokens."""
    from tailored_avsr_tpu.decode.maskctc import _collapse_row
    from tailored_avsr_tpu_torch.decode.maskctc import collapse_rows

    logp, lens = _ctc_case(len(lengths), lengths)
    probs, ids = np.exp(logp.max(-1)), logp.argmax(-1).astype(np.int32)
    want = jax.vmap(lambda p, i, n: _collapse_row(p, i, n, 0, 99))(probs, ids, lens)
    got = collapse_rows(t(probs), t(ids), t(lens), 0, 99)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].max() > 1 and (lengths[-1] > 0 or got[2][-1] == 0)


def _mlm_tables(seed, t_max, v, mask_token):
    """A stand-in MLM: logits[b, p] = tok[ys[b, p]] + pos[p], the same numbers
    in both packages; positions 1 and 3 get equal rows (equal confidence
    when both are masked)."""
    rs = np.random.RandomState(seed)
    tok = (2.0 * rs.randn(mask_token + 1, v + 1)).astype(np.float32)
    pos = (2.0 * rs.randn(t_max + 1, v + 1)).astype(np.float32)
    pos[3] = pos[1]
    return tok, pos


@pytest.mark.parametrize("case", ["many_masks", "fewer_masks_than_rounds", "b1", "one_round"])
def test_maskctc_decode_matches_jax(case):
    """Tokens and lengths identical, ties broken in position order, and the
    eos written at each length (read at length + 1)."""
    from tailored_avsr_tpu.decode.maskctc import maskctc_decode as jdecode
    from tailored_avsr_tpu_torch.decode.maskctc import maskctc_decode

    v, mask_token = 7, 7
    lengths, thr, iters = {"many_masks": ((12, 9, 0), 0.999, 3), "fewer_masks_than_rounds": ((12, 10, 5), 0.7, 10),
                           "b1": ((11,), 0.95, 4), "one_round": ((12, 6, 3), 0.999, 1)}[case]
    logp, lens = _ctc_case(7, lengths)
    tok, pos = _mlm_tables(8, logp.shape[1], v, mask_token)
    seen = []

    def jfn(ys, n):
        return jnp.asarray(tok)[ys] + jnp.asarray(pos)[None, : ys.shape[1]]

    def pfn(ys, n):
        seen.append((ys.clone(), n.clone()))
        return t(tok)[ys.long()] + t(pos)[None, : ys.shape[1]]

    want = jdecode(jnp.asarray(logp), jnp.asarray(lens), jfn, mask_token, threshold=thr, num_iterations=iters, eos=6)
    got = maskctc_decode(t(logp), t(lens), pfn, mask_token, threshold=thr, num_iterations=iters, eos=6)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert len(seen) == iters
    ys0, n0 = seen[0]
    for i, n in enumerate(got.lengths.tolist()):
        assert int(n0[i]) == n + 1 and int(ys0[i, n]) == 6
        assert not (got.tokens[i, :n] == mask_token).any()  # every mask filled
    masked = [int((ys0[i, :n] == mask_token).sum()) for i, n in enumerate(got.lengths.tolist())]
    assert sum(masked) > 0 and (case != "fewer_masks_than_rounds" or max(masked) < iters)


# ---------------------------------------------------------------- models


def _maskctc_models(path, seed, **encoder):
    """(cfg, JAX model, random variables, port model loaded from them, args)."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    cfg = tiny_cfg(path, **encoder)
    cfg.model = "maskctc"
    text = speech_batch("asr")
    if cfg.task == "avsr":
        b = dict(_batch())
        args = tuple(b[k] for k in ("audio", "audio_lengths", "video", "video_lengths"))
    else:
        args = (text["speech"], text["speech_lengths"])
    jm = (AVSRTask if cfg.task == "avsr" else ASRTask).build_model(cfg, list(TOKEN_LIST))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *args, text["text"], text["text_lengths"]))
    variables = _random_variables(shapes, seed=seed)
    pm = build_model(cfg, list(TOKEN_LIST), device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == [] and sd["decoder.embed.0.weight"].shape[0] == len(TOKEN_LIST) + 1
    pm.load_state_dict(sd, strict=True)
    return cfg, jm, variables, pm, args + (text["text"], text["text_lengths"])


def test_maskctc_loss_and_gradients_match_jax():
    """The AVSR Mask-CTC loss (eval, rates 0) given the JAX package's own
    eval masks: ``0.3 ctc + 0.7 mlm`` and its terms within 1e-5 relative,
    acc exact, every gradient as the module docstring states."""
    from tailored_avsr_tpu.models.maskctc import mask_uniform as jmask

    cfg, jm, variables, pm, args = _maskctc_models(MASKCTC, 4, **TINY_ATTN)
    vocab = len(TOKEN_LIST)
    ys_in, ys_out = jmask(jnp.asarray(args[-2]), jnp.asarray(args[-1]), vocab, vocab - 1, -1, jax.random.PRNGKey(0))

    def loss_fn(p):
        return jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, *args, deterministic=True)

    (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    pm.eval()
    pm.attention_targets = lambda text, lens, generator=None: (t(ys_in).to(text.dtype), t(ys_out).to(text.dtype))
    loss, stats = pm(*(t(a) for a in args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in ("loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(stats[key].detach()), float(want_stats[key]), rtol=1e-5)
    assert stats["loss_mlm"] is stats["loss_att"] and float(stats["acc"]) == float(want_stats["acc"])
    want = {k: np.asarray(v) for k, v in export_torch_state_dict({"params": want_grads}).items()}
    named = dict(pm.named_parameters())
    assert set(want) == set(named)
    floor = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for name, p in named.items():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=floor + 1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def test_mask_uniform_distribution_matches_jax():
    """4,000 draws of utterances of 10, 4 and 1 tokens in both packages: each
    masked count k in [1, n] at frequency 1/n and each position masked at
    (n+1)/(2n), within 5 standard errors; nothing past the length masked,
    eos appended; the port's eval masks are the same on every call and its
    train masks follow the generator."""
    from tailored_avsr_tpu.models.maskctc import mask_uniform as jmask
    from tailored_avsr_tpu_torch.models.maskctc import mask_uniform

    reps, lens, mask, eos = 4000, np.array([10, 4, 1], np.int32), 37, 36
    text = np.full((3 * reps, 10), -1, np.int32)
    for i, n in enumerate(np.tile(lens, reps)):
        text[i, :n] = 5 + (np.arange(n) % 20)
    tl = np.tile(lens, reps)
    jin, jout = (np.asarray(x) for x in jmask(jnp.asarray(text), jnp.asarray(tl), mask, eos, -1,
                                               jax.random.PRNGKey(5)))
    pin, pout = (x.numpy() for x in mask_uniform(t(text), t(tl), mask, eos, -1, torch.Generator().manual_seed(5)))
    for ys_in, ys_out in ((jin, jout), (pin, pout)):
        assert ys_in.shape == (3 * reps, 11) and (ys_in[:, -1] == eos).all() and (ys_out[:, -1] == -1).all()
        masked = ys_in[:, :10] == mask
        np.testing.assert_array_equal(masked, ys_out[:, :10] != -1)
        np.testing.assert_array_equal(ys_out[:, :10][masked], text[masked])
        np.testing.assert_array_equal(ys_in[:, :10][~masked & (text != -1)], text[~masked & (text != -1)])
        assert (ys_in[:, :10][text == -1] == eos).all()
        for j, n in enumerate(lens):
            rows = masked[j::3]
            counts = rows.sum(1)
            assert counts.min() >= 1 and counts.max() <= n and not rows[:, n:].any()
            for k in range(1, n + 1):
                p = 1.0 / n
                assert abs((counts == k).mean() - p) <= 5 * np.sqrt(p * (1 - p) / reps)
            q = (n + 1) / (2 * n)
            assert np.abs(rows[:, :n].mean(0) - q).max() <= 5 * np.sqrt(q * (1 - q) / reps) + 1e-9
    cfg, _, _, pm, args = _maskctc_models(ASR, 1)
    text, lens = t(args[-2]), t(args[-1])
    pm.eval()
    assert all(torch.equal(a, b) for a, b in zip(pm.attention_targets(text, lens), pm.attention_targets(text, lens)))
    pm.train()
    draws = {tuple(pm.attention_targets(text, lens, torch.Generator().manual_seed(s))[0].flatten().tolist())
             for s in range(6)}
    assert len(draws) > 1


@pytest.mark.parametrize("path", [MASKCTC, ASR], ids=["avsr_tailored", "asr_branchformer"])
def test_maskctc_speech2text_matches_jax(path):
    """``nbest``: one hypothesis a utterance, ids identical (no ``<sos>``
    strip), score 0; with random weights every CTC posterior is under the
    config's 0.99, so every token goes through the MLM rounds. An LM config
    takes no part."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg, _, variables, pm, args = _maskctc_models(path, 6, **(TINY_ATTN if path == MASKCTC else {}))
    assert cfg.inference_conf.get("maskctc_threshold_probability", 0.999) >= 0.99
    js = JaxSpeech2Text(copy.deepcopy(cfg))
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ps = Speech2Text(copy.deepcopy(cfg), device="cpu")
    ps.model.load_state_dict(pm.state_dict(), strict=True)
    keys = ("audio", "audio_lengths", "video", "video_lengths") if cfg.task == "avsr" else ("speech", "speech_lengths")
    batch = dict(zip(keys, args))
    want, got = js.nbest(batch), ps.nbest(batch)
    assert [len(h) for h in got] == [1, 1] and all(h[0][3] == 0.0 for h in got)
    assert [h[0][2] for h in got] == [h[0][2] for h in want] and any(h[0][2] for h in got)
    assert ps.greedy(batch) == js.greedy(batch)
