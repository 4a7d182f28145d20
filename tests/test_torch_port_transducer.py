"""The port's RNN transducer against the JAX package, in f32 on the CPU: the
joint and prediction networks (forward and ``step``), ``rnnt_loss`` and
``multiblank_rnnt_loss`` with their gradients, the greedy, chunked,
multi-blank greedy and ALSD beam decoders, the ASR transducer model's loss
and gradients, and ``Speech2Text.nbest`` of a tiny ASR transducer (greedy
and beam) and of a tiny AVSR (tailored) transducer.

Weights come from the JAX init (perturbed) or ``_random_variables`` and
load into the port through the key-grammar export (the packed LSTM keys
among them) with a strict load. Tolerances: network outputs 1e-5 abs;
loss values and gradients 1e-5 relative (gradients: of their tensor's
largest JAX entry); decoded tokens and lengths identical; beam scores
within 1e-4 (the finished buffer's unfilled entries, at NEG_INF, by that
bound alone).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
from test_torch_port_branchformer import TOKEN_LIST, _load, speech_batch, tiny_cfg
from test_torch_port_ops import jax_module
from test_torch_port_slice import _batch, _random_variables

TRANSDUCER = "configs/ASR/branchformer_transducer_spanish.yaml"
MASKCTC = "configs/AVSR/tailored_maskctc_spanish.yaml"
D, H, E, J, V = 16, 12, 10, 20, 9  # encoder, LSTM hidden, embedding, joint widths; vocabulary


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- networks


def _under(root, variables):
    """JAX variables as if they sat under model attribute ``root`` (the key
    grammar depends on it)."""
    return {c: {root: tree} for c, tree in variables.items()}


@pytest.fixture(scope="module")
def nets():
    """A JAX joint network and 2-layer prediction network with their
    perturbed weights, and the port's twins loaded from them."""
    from tailored_avsr_tpu.ops.rnnt import JointNetwork as JJ
    from tailored_avsr_tpu.ops.rnnt import PredictionNetwork as JP
    from tailored_avsr_tpu_torch.ops.rnnt import JointNetwork, PredictionNetwork

    jj = JJ(vocab_size=V, joint_dim=J)
    jp = JP(vocab_size=V, embed_dim=E, hidden_dim=H, num_layers=2, dropout_rate=0.0)
    vj = jax_module(jj, np.zeros((1, 3, 1, D), np.float32), np.zeros((1, 1, 4, H), np.float32))
    vp = jax_module(jp, np.zeros((1, 3), np.int32))
    pj = _load(JointNetwork(V, D, H, joint_dim=J), _under("joint_network", vj), "joint_network.")
    pp = _load(PredictionNetwork(V, E, H, num_layers=2, dropout_rate=0.0), _under("prediction_network", vp),
               "decoder.")
    return {"jj": jj, "jp": jp, "vj": vj, "vp": vp, "pj": pj, "pp": pp}


def test_lstm_keys_pack_as_torch(nets):
    """The prediction network's export is torch's packed LSTM layout, bias_ih
    zeros, and the port's state dict has exactly those keys."""
    sd = export_torch_state_dict({"params": {"prediction_network": nets["vp"]["params"]}})
    assert set(sd) == {f"decoder.{k}" for k in nets["pp"].state_dict()}
    assert sd["decoder.decoder.1.weight_ih_l0"].shape == (4 * H, H)
    assert sd["decoder.decoder.0.weight_ih_l0"].shape == (4 * H, E)
    assert not sd["decoder.decoder.0.bias_ih_l0"].any() and sd["decoder.decoder.0.bias_hh_l0"].any()


def test_joint_and_prediction_networks_match_jax(nets):
    """Forward over ignore-padded labels and the joint's broadcast within
    1e-5; ``step`` from the start label -1, then from real labels, state
    and output within 1e-5; relu joints too."""
    from tailored_avsr_tpu.ops.rnnt import JointNetwork as JJ
    from tailored_avsr_tpu_torch.ops.rnnt import JointNetwork

    rs = np.random.RandomState(0)
    labels = rs.randint(1, V, (3, 5)).astype(np.int32)
    labels[1, 3:] = -1
    labels[2, :] = -1
    jp, vp, pp = nets["jp"], nets["vp"], nets["pp"]
    want_g = jp.apply(vp, labels)
    with torch.no_grad():
        got_g = pp(t(labels))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5)
    enc = rs.randn(3, 4, D).astype(np.float32)
    want = nets["jj"].apply(nets["vj"], enc[:, :, None, :], np.asarray(want_g)[:, None, :, :])
    with torch.no_grad():
        got = nets["pj"](t(enc)[:, :, None, :], got_g[:, None, :, :])
    assert got.shape == (3, 4, 6, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    jstate = jp.apply(vp, 3, method=jp.initial_state)
    pstate = pp.initial_state(3)
    for step_labels in ([-1, -1, -1], [4, 0, 8], [-1, 2, 2]):
        lab = np.asarray(step_labels, np.int32)
        jstate, jout = jp.apply(vp, jstate, lab, method=jp.step)
        with torch.no_grad():
            pstate, pout = pp.step(pstate, t(lab))
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-5)
        for (pc, ph), (jc, jh) in zip(pstate, jstate):
            np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
            np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-5)

    jr = JJ(vocab_size=V, joint_dim=J, activation="relu")
    pr = _load(JointNetwork(V, D, H, joint_dim=J, activation="relu"), _under("joint_network", nets["vj"]),
               "joint_network.")
    g = rs.randn(3, 1, 2, H).astype(np.float32)
    with torch.no_grad():
        got = pr(t(enc)[:, :, None, :], t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(jr.apply(nets["vj"], enc[:, :, None, :], g)), atol=1e-5)


# ---------------------------------------------------------------- losses

LOSS_CASES = {
    "standard": {},
    "multiblank": {"durations": (2, 4), "sigma": 0.05},
    "multiblank_one_sigma0": {"durations": (3,), "sigma": 0.0},
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_rnnt_losses_and_gradients_match_jax(case):
    """Value and d loss / d logits within 1e-5 relative, over utterances of
    full length, shorter frames, an empty label sequence and one label."""
    from tailored_avsr_tpu.ops import rnnt as jr
    from tailored_avsr_tpu_torch.ops import rnnt as pr

    kw = LOSS_CASES[case]
    rs = np.random.RandomState(len(case))
    b, tt, u, v = 4, 7, 4, 8
    logits = (2.0 * rs.randn(b, tt, u + 1, v)).astype(np.float32)
    logit_lengths = np.array([7, 5, 6, 3], np.int32)
    label_lengths = np.array([4, 2, 0, 1], np.int32)
    labels = rs.randint(4, v, (b, u)).astype(np.int32)
    labels[np.arange(u)[None, :] >= label_lengths[:, None]] = -1
    if kw:
        blank = len(kw["durations"])

        def jfn(x):
            return jr.multiblank_rnnt_loss(x, logit_lengths, labels, label_lengths, blank, kw["durations"],
                                           kw["sigma"])

        def pfn(x):
            return pr.multiblank_rnnt_loss(x, t(logit_lengths), t(labels), t(label_lengths), blank,
                                           kw["durations"], kw["sigma"])
    else:
        def jfn(x):
            return jr.rnnt_loss(x, logit_lengths, labels, label_lengths)

        def pfn(x):
            return pr.rnnt_loss(x, t(logit_lengths), t(labels), t(label_lengths))
    want, want_grad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(logits))
    x = t(logits).clone().requires_grad_(True)
    got = pfn(x)
    got.backward()
    assert np.isfinite(float(got)) and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max())


# ---------------------------------------------------------------- decoders


def _decoder_fns(nets):
    """(JAX pred/joint apply, port pred/joint apply) on the same weights."""
    jp, vp, jj, vj, pp, pj = (nets[k] for k in ("jp", "vp", "jj", "vj", "pp", "pj"))

    def jpred(state, label):
        return jp.apply(vp, state, label, method=jp.step)

    def jjoint(e, g):
        return jj.apply(vj, e[:, None, None], g[:, None, None]).reshape(e.shape[0], -1)

    def pjoint(e, g):
        return pj(e[:, None, None], g[:, None, None]).reshape(e.shape[0], -1)

    return jpred, jjoint, pp.step, pjoint


def _enc(seed, b=3, tt=6):
    """Encoder frames (the third utterance one frame long)."""
    rs = np.random.RandomState(seed)
    return (1.5 * rs.randn(b, tt, D)).astype(np.float32), np.array([tt, tt - 2, 1][:b], np.int32)


@pytest.mark.parametrize("max_symbols", [1, 3])
def test_greedy_decode_matches_jax(nets, max_symbols):
    """Tokens and counts identical; decoding the frames in two chained chunks
    gives the one-pass result."""
    from tailored_avsr_tpu.ops.rnnt import transducer_greedy_decode as jgreedy
    from tailored_avsr_tpu_torch.ops.rnnt import transducer_greedy_chunk, transducer_greedy_decode

    jpred, jjoint, ppred, pjoint = _decoder_fns(nets)
    enc, lens = _enc(1)
    jstate = nets["jp"].apply(nets["vp"], 3, method=nets["jp"].initial_state)
    want_tok, want_n = jgreedy(jnp.asarray(enc), jnp.asarray(lens), jpred, jjoint, jstate,
                               max_symbols_per_frame=max_symbols)
    with torch.no_grad():
        got_tok, got_n = transducer_greedy_decode(t(enc), t(lens), ppred, pjoint, nets["pp"].initial_state(3),
                                                  max_symbols_per_frame=max_symbols)
        carry = (nets["pp"].initial_state(3), torch.full((3,), -1, dtype=torch.int32))
        parts, counts = [], []
        for lo, hi in ((0, 4), (4, 6)):
            tok, n, carry = transducer_greedy_chunk(t(enc[:, lo:hi]), (t(lens) - lo).clamp(0, hi - lo), ppred,
                                                    pjoint, carry, max_symbols)
            parts.append([tok[i, :n[i]].tolist() for i in range(3)])
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_n.sum() > 0 and (got_n < 6 * max_symbols).any()
    assert [a + b for a, b in zip(*parts)] == [got_tok[i, :got_n[i]].tolist() for i in range(3)]


def test_multiblank_greedy_decode_matches_jax(nets):
    """Durations (2, 3): big blanks at indices 1 and 0, the blank at 2;
    tokens and counts identical, and some frames are skipped by big blanks."""
    from tailored_avsr_tpu.ops.rnnt import multiblank_greedy_decode as jmb
    from tailored_avsr_tpu_torch.ops.rnnt import multiblank_greedy_decode

    jpred, jjoint, ppred, pjoint = _decoder_fns(nets)
    enc, lens = _enc(2, tt=8)
    jstate = nets["jp"].apply(nets["vp"], 3, method=nets["jp"].initial_state)
    want_tok, want_n = jmb(jnp.asarray(enc), jnp.asarray(lens), jpred, jjoint, jstate, blank_id=2, durations=(2, 3))
    with torch.no_grad():
        got_tok, got_n = multiblank_greedy_decode(t(enc), t(lens), ppred, pjoint, nets["pp"].initial_state(3),
                                                  blank_id=2, durations=(2, 3))
        sym = pjoint(t(enc).reshape(-1, D), nets["pp"].step(nets["pp"].initial_state(24),
                                                             torch.full((24,), -1, dtype=torch.int32))[1])
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_n.sum() > 0 and (sym.argmax(-1) < 2).any()  # big blanks are among the argmaxes


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no_merge"])
def test_beam_search_matches_jax(nets, merge):
    """K = 4, prune 4, max_symbols = T: finished tokens and lengths
    identical, scores within 1e-4 (unfilled entries both at NEG_INF)."""
    from tailored_avsr_tpu.decode.transducer_beam import transducer_beam_search as jbeam
    from tailored_avsr_tpu_torch.decode.transducer_beam import NEG_INF, transducer_beam_search

    jpred, jjoint, ppred, pjoint = _decoder_fns(nets)
    enc, lens = _enc(3, tt=5)
    k = 4
    jstate = nets["jp"].apply(nets["vp"], 3 * k, method=nets["jp"].initial_state)
    want = jax.device_get(jbeam(jnp.asarray(enc), jnp.asarray(lens), jpred, jjoint, jstate, beam_size=k,
                                max_symbols=5, merge_prefixes=merge))
    with torch.no_grad():
        got = transducer_beam_search(t(enc), t(lens), ppred, pjoint, nets["pp"].initial_state(3 * k), beam_size=k,
                                     max_symbols=5, merge_prefixes=merge)
    _same_beam(got, want, NEG_INF)


def _same_beam(got, want, neg_inf):
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    live = ws > neg_inf / 2
    np.testing.assert_array_equal(gs > neg_inf / 2, live)
    np.testing.assert_allclose(gs[live], ws[live], atol=1e-4, rtol=0)
    assert live.sum() > gs.shape[0] and (got.lengths.numpy()[live] > 0).any()


def test_beam_ties_go_to_the_lower_index():
    """A joint whose every token ties: the stable top-k keeps JAX's choice
    among equal candidates (the lowest index), merge on."""
    from tailored_avsr_tpu.decode.transducer_beam import transducer_beam_search as jbeam
    from tailored_avsr_tpu_torch.decode.transducer_beam import NEG_INF, transducer_beam_search

    b, tt, k = 2, 3, 3
    lens = np.array([3, 2], np.int32)
    base = np.array([0.5, 0.0, 0.0, 0.0, 0.0, -1.0], np.float32)  # blank, four equal tokens, one low

    def jpred(state, label):
        return state, jnp.zeros((label.shape[0], 1))

    def jjoint(e, g):
        return jnp.broadcast_to(jnp.asarray(base), (e.shape[0], base.size)) + 0.0 * e[:, :1]

    def ppred(state, label):
        return state, torch.zeros((label.shape[0], 1))

    def pjoint(e, g):
        return t(base).expand(e.shape[0], base.size) + 0.0 * e[:, :1]

    enc = np.zeros((b, tt, 1), np.float32)
    state_j = ((jnp.zeros((b * k, 1)), jnp.zeros((b * k, 1))),)
    state_p = ((torch.zeros(b * k, 1), torch.zeros(b * k, 1)),)
    want = jax.device_get(jbeam(jnp.asarray(enc), jnp.asarray(lens), jpred, jjoint, state_j, beam_size=k,
                                max_symbols=tt))
    with torch.no_grad():
        got = transducer_beam_search(t(enc), t(lens), ppred, pjoint, state_p, beam_size=k, max_symbols=tt)
    _same_beam(got, want, NEG_INF)


# ---------------------------------------------------------------- models and Speech2Text


def _transducer_models(path, seed, **extra):
    """(cfg, JAX model, random variables, port model loaded from them)."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    cfg = tiny_cfg(path, **extra)
    cfg.decoder_conf = {"embed_size": 24, "hidden_size": 32, "num_layers": 1, "dropout_rate": 0.0}
    cfg.joint_net_conf = {"joint_space_size": 40}
    if cfg.task == "avsr":
        cfg.model, cfg.decoder = "espnet", "transducer"
        b = dict(_batch())
        args = tuple(b[k] for k in ("audio", "audio_lengths", "video", "video_lengths"))
    else:
        b = speech_batch("asr")
        args = (b["speech"], b["speech_lengths"])
    text = speech_batch("asr")
    jm = (AVSRTask if cfg.task == "avsr" else ASRTask).build_model(cfg, list(TOKEN_LIST))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *args, text["text"], text["text_lengths"]))
    variables = _random_variables(shapes, seed=seed)
    pm = build_model(cfg, list(TOKEN_LIST), device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    return cfg, jm, variables, pm, args + (text["text"], text["text_lengths"])


def test_transducer_model_loss_and_gradients_match_jax():
    """The ASR transducer's ``rnnt + 0.3 ctc`` (eval, rates 0): loss and its
    terms within 1e-5 relative, every parameter's gradient within 1e-4 of
    its tensor's largest JAX entry plus 1e-5 of the model's largest."""
    cfg, jm, variables, pm, args = _transducer_models(TRANSDUCER, seed=3)

    def loss_fn(p):
        return jm.apply({"params": p}, *args, deterministic=True)

    (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    pm.eval()
    loss, stats = pm(*(torch.from_numpy(np.asarray(a)) for a in args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in ("loss_ctc", "loss_transducer"):
        np.testing.assert_allclose(float(stats[key].detach()), float(want_stats[key]), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in export_torch_state_dict({"params": want_grads}).items()}
    named = dict(pm.named_parameters())
    assert set(want) - set(named) == {"decoder.decoder.0.bias_ih_l0"}  # a buffer: flax has no input-side bias
    floor = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for name, p in named.items():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=floor + 1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def _engines(path, seed, inference_conf, **extra):
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg, _, variables, pm, args = _transducer_models(path, seed, **extra)
    cfg.inference_conf = dict(cfg.inference_conf, **inference_conf)
    js = JaxSpeech2Text(copy.deepcopy(cfg))
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ps = Speech2Text(copy.deepcopy(cfg), device="cpu")
    ps.model.load_state_dict(pm.state_dict(), strict=True)
    keys = ("audio", "audio_lengths", "video", "video_lengths") if cfg.task == "avsr" else ("speech", "speech_lengths")
    return js, ps, dict(zip(keys, args))


@pytest.mark.parametrize("quantize", [None, "bfloat16", "qint8"], ids=["f32", "bf16_weights", "qint8"])
@pytest.mark.parametrize("beam", [1, 4], ids=["greedy", "beam4"])
def test_asr_transducer_speech2text_matches_jax(beam, quantize):
    """Tiny ASR transducer: ``nbest`` ids identical (no ``<sos>`` strip),
    beam scores within 1e-4; greedy stays CTC greedy. With weight
    quantisation (``quantize_min_size`` 256 picks the prediction network's
    embedding, LSTM and joint) the JAX variables go through
    ``quantize_variables``, as its ``ensure_params`` would: a bf16-stored
    embedding under the f32 LSTM runs the cell in f32, as flax promotes."""
    conf = {"beam_size": beam}
    if quantize:
        conf.update(quantize_asr_model=True, quantize_dtype=quantize, quantize_min_size=256)
    js, ps, batch = _engines(TRANSDUCER, 7, conf)
    if quantize:
        from tailored_avsr_tpu.utils.quantize import quantize_variables

        js.variables = quantize_variables(js.variables, quantize, min_size=256)
    want, got = js.nbest(batch), ps.nbest(batch)
    assert len(got) == 2 and [len(h) for h in got] == [len(h) for h in want] == [beam, beam]
    for g_hyps, w_hyps in zip(got, want):
        assert [h[2] for h in g_hyps] == [h[2] for h in w_hyps]
        for g, w in zip(g_hyps, w_hyps):
            assert (g[3] > -1e9) == (w[3] > -1e9)
            if w[3] > -1e9:
                assert abs(g[3] - w[3]) <= 1e-4
    assert any(h[0][2] for h in got)
    assert ps.greedy(batch) == js.greedy(batch)


def test_avsr_transducer_speech2text_matches_jax():
    """A tiny tailored AVSR encoder with the transducer decoder: greedy
    transducer ids identical."""
    js, ps, batch = _engines(MASKCTC, 9, {"beam_size": 1}, acoustic_use_attn=[False, True],
                             visual_use_attn=[True, False])
    want, got = js.nbest(batch), ps.nbest(batch)
    assert [h[0][2] for h in got] == [h[0][2] for h in want]
    assert any(h[0][2] for h in got) and all(h[0][3] == 0.0 for h in got)


def test_multi_blank_vocabulary_and_greedy_match_jax():
    """``transducer_multi_blank_durations`` [2, 4]: both packages insert
    ``<blank4>``, ``<blank2>`` before ``<blank>`` (in place), build the same
    names and shapes, and decode with the multi-blank greedy to the same ids
    whatever the beam size."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu_torch.tasks.asr import build_meta

    cfg = tiny_cfg(TRANSDUCER)
    cfg.model_conf = dict(cfg.model_conf, transducer_multi_blank_durations=[2, 4], transducer_multi_blank_sigma=0.05)
    jt, pt = list(TOKEN_LIST), list(TOKEN_LIST)
    ASRTask.build_model(cfg, jt)
    pm = build_meta(cfg, pt)
    assert pt == jt == ["<blank4>", "<blank2>"] + TOKEN_LIST and pm.transducer_multi_blank_durations == (2, 4)
    assert pm.joint_network.lin_out.out_features == len(TOKEN_LIST) + 2

    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    cfg.inference_conf = dict(cfg.inference_conf, beam_size=4)
    js = JaxSpeech2Text(copy.deepcopy(cfg))
    b = speech_batch("asr")
    shapes = jax.eval_shape(lambda: js.model.init({"params": jax.random.PRNGKey(0)}, b["speech"], b["speech_lengths"],
                                                  b["text"], b["text_lengths"]))
    variables = _random_variables(shapes, seed=12)
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ps = Speech2Text(copy.deepcopy(cfg), device="cpu")
    ps.model.load_state_dict(convert_jax_variables(variables, ps.model)[0], strict=True)
    batch = {k: b[k] for k in ("speech", "speech_lengths")}
    got, want = ps.nbest(batch), js.nbest(batch)
    assert [len(h) for h in got] == [1, 1] and [h[0][2] for h in got] == [h[0][2] for h in want]


def test_gru_prediction_network_raises_as_in_jax():
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu_torch.tasks.common import build_model

    cfg = tiny_cfg(TRANSDUCER)
    cfg.decoder_conf = dict(cfg.decoder_conf, rnn_type="gru")
    for build in (lambda: ASRTask.build_model(cfg, list(TOKEN_LIST)),
                  lambda: build_model(cfg, list(TOKEN_LIST), device="cpu")):
        with pytest.raises(NotImplementedError, match="rnn_type='gru'"):
            build()
