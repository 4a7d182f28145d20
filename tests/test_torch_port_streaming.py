"""The contextual-block encoder and its three streamers, the port against
the JAX package in f32 on the CPU (mirrors ``tests/test_streaming.py``).

- The encoder, Transformer and Conformer block layers: the port's offline
  encode against the JAX one within 1e-4, CTC ids equal.
- ``ContextualBlockStreamer`` fed in irregular chunks (an odd length, so
  the flush runs a partial tail): the port streamed against the port
  offline within 1e-5 with the greedy ids equal, and against the JAX
  streamer; the ``linear`` input layer; a non-block encoder refused.
- ``TransducerStreamer`` and ``TimesyncStreamer``: tokens equal to the
  port's offline greedy transducer decode and time-synchronous beam over
  the whole utterance, and to the JAX streamers'.
"""

from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_slice import _random_variables

V, D, F = 7, 16, 20
ENC = {"output_size": D, "attention_heads": 2, "linear_units": 24, "num_blocks": 2, "block_size": 8, "hop_size": 4,
       "dropout_rate": 0.0, "positional_dropout_rate": 0.0}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair(layer="contextual_block_transformer", input_layer="conv2d", seed=0, t=245, transducer=False):
    """(JAX model, its variables, the port model on them, (B, T, F) features):
    a CTC-only ASR model, or with ``transducer`` the task's transducer model."""
    from tailored_avsr_tpu.models.asr_model import ASRModel
    from tailored_avsr_tpu.models.ctc import CTCHead
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu.tasks.common import build_encoder
    from tailored_avsr_tpu_torch.tasks import common
    from tailored_avsr_tpu_torch.tasks.asr import build_model

    conf = dict(ENC, input_layer=input_layer)
    key = jax.random.PRNGKey(seed)
    feats = np.asarray(jax.random.normal(key, (2, t, F)))
    flens = np.full((2,), t, np.int32)
    if transducer:
        cfg = Namespace(task="asr", frontend="none", encoder=layer, encoder_conf=conf, decoder="transducer",
                        decoder_conf={"embed_size": D, "hidden_size": D, "num_layers": 1, "dropout_rate": 0.0},
                        joint_net_conf={"joint_space_size": 16}, model="espnet", model_conf={"ctc_weight": 0.3},
                        input_size=F)
        tokens = [f"t{i}" for i in range(V)]
        jm = ASRTask.build_model(cfg, list(tokens))
        pm = build_model(cfg, list(tokens), device="cpu")
    else:
        jm = ASRModel(vocab_size=V, encoder=build_encoder(layer, conf), ctc=CTCHead(V), ctc_weight=1.0)
        pm = common.materialize(_port_model(layer, conf), None, "cpu", None)
    shapes = jax.eval_shape(lambda: jm.init(key, feats, flens, np.array([[1, 2, -1], [3, -1, -1]], np.int32),
                                            np.array([2, 1], np.int32)))
    variables = _random_variables(shapes, seed)  # traced, not run: no JAX compile
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    return jm, variables, pm.eval(), feats


def _port_model(layer, conf):
    """The port's CTC-only ASR model on a contextual-block encoder, on the
    meta device."""
    from tailored_avsr_tpu_torch.models.asr_model import ASRModel
    from tailored_avsr_tpu_torch.tasks import common

    enc = common.build_encoder(layer, dict(conf), input_size=F)
    return ASRModel(V, enc, common.CTCHead(D, V, **common.META), ctc_weight=1.0)


def _stream(st, feats, cuts):
    st.reset(feats.shape[0])
    parts = [st.accept(feats[:, a:b]) for a, b in zip(cuts, cuts[1:])]
    parts.append(st.finalize())
    return np.concatenate([p[0] for p in parts], axis=1), np.concatenate([p[1] for p in parts], axis=1)


CUTS = [0, 37, 101, 151, 164, 245]  # irregular chunks; 245 frames: a partial tail for the flush


@pytest.mark.parametrize("layer", ["contextual_block_transformer", "contextual_block_conformer"])
def test_streamed_and_offline_encoders_match_jax(layer):
    """Offline: the port's encode within 1e-4 of JAX's, the same lengths and
    CTC ids. Streamed: within 1e-5 of the port's offline encode, ids equal
    to its CTC argmax, and within 1e-4 of the JAX streamer (ids equal)."""
    from tailored_avsr_tpu.decode.streaming import ContextualBlockStreamer as JaxStreamer
    from tailored_avsr_tpu_torch.decode.streaming import ContextualBlockStreamer

    jm, variables, pm, feats = _pair(layer)
    flens = np.full((2,), feats.shape[1], np.int32)
    want, want_lens, _ = jax.jit(lambda v: jm.apply(v, feats, flens, method="encode"))(variables)
    with torch.no_grad():
        got, got_lens, _ = pm.encode(torch.from_numpy(feats), torch.from_numpy(flens))
        offline_ids = pm.ctc.argmax(got).numpy()
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    jax_ids = np.asarray(jm.apply(variables, want, method=lambda m, x: m.ctc.argmax(x)))
    np.testing.assert_array_equal(offline_ids, jax_ids)

    y, ids = _stream(ContextualBlockStreamer(pm), feats, CUTS)
    assert y.shape == tuple(got.shape)
    np.testing.assert_allclose(y, got.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ids, offline_ids)
    jy, jids = _stream(JaxStreamer(jm, variables), feats, [0, 101, 245])  # fewer chunks: fewer JAX compiles
    np.testing.assert_allclose(y, jy, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ids, jids)


def test_streaming_linear_input_layer():
    """The ``linear`` input layer (no subsampling): streamed equal to offline
    within 1e-5, and to the JAX streamer within 1e-4."""
    from tailored_avsr_tpu.decode.streaming import ContextualBlockStreamer as JaxStreamer
    from tailored_avsr_tpu_torch.decode.streaming import ContextualBlockStreamer

    jm, variables, pm, feats = _pair(input_layer="linear", seed=1, t=30)
    with torch.no_grad():
        want = pm.encode(torch.from_numpy(feats), torch.full((2,), 30))[0].numpy()
    cuts = [0, 11, 25, 30]
    y, _ = _stream(ContextualBlockStreamer(pm), feats, cuts)
    np.testing.assert_allclose(y, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, _stream(JaxStreamer(jm, variables), feats, cuts)[0], atol=1e-4, rtol=0)


def test_streaming_rejects_non_block_encoder():
    from tailored_avsr_tpu_torch.decode.streaming import ContextualBlockStreamer
    from tailored_avsr_tpu_torch.models.asr_model import ASRModel
    from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder
    from tailored_avsr_tpu_torch.models.ctc import CTCHead

    enc = BranchformerEncoder(output_size=D, input_size=F, attention_heads=2, linear_units=24, cgmlp_linear_units=24,
                              cgmlp_conv_kernel=7, num_blocks=1, dropout_rate=0.0)
    with pytest.raises(ValueError, match="contextual_block"):
        ContextualBlockStreamer(ASRModel(V, enc, CTCHead(D, V), ctc_weight=1.0))


def test_transducer_streamer_matches_offline_and_jax():
    """Chunked transducer decoding: the tokens of the port's offline greedy
    transducer decode over the whole utterance, and of the JAX streamer."""
    from tailored_avsr_tpu.decode.streaming import TransducerStreamer as JaxStreamer
    from tailored_avsr_tpu_torch.decode.streaming import TransducerStreamer
    from tailored_avsr_tpu_torch.ops.attention import promoted_linear
    from tailored_avsr_tpu_torch.ops.rnnt import transducer_greedy_decode

    jm, variables, pm, feats = _pair(seed=3, t=203, transducer=True)
    joint, pred = pm.joint_network, pm.prediction_network
    with torch.no_grad():
        enc, lens, _ = pm.encode(torch.from_numpy(feats), torch.full((2,), 203))
        toks, cnt = transducer_greedy_decode(promoted_linear(joint.lin_enc, enc), lens, pred.step,
                                             joint.from_projected, pred.initial_state(2))
    offline = [[int(x) for x in toks[i, :int(cnt[i])]] for i in range(2)]
    streamed = []
    # the JAX streamer in fewer chunks: each chunk shape is a JAX compile
    for st, cuts in ((TransducerStreamer(pm), [0, 57, 123, 170, 203]), (JaxStreamer(jm, variables), [0, 123, 203])):
        st.reset(2)
        out = [[] for _ in range(2)]
        for part in [st.accept(feats[:, a:b]) for a, b in zip(cuts, cuts[1:])] + [st.finalize()]:
            for i in range(2):
                out[i].extend(int(x) for x in part[i])
        streamed.append(out)
    assert streamed[0] == offline == streamed[1]
    assert any(offline)  # a decode that emits


def test_timesync_streamer_matches_offline_and_jax():
    """Streamed time-synchronous beam (beam 4, penalty 0.2): partial
    hypotheses along the way, the final best equal to the port's offline
    search and to the JAX streamer's, and its live n-best to JAX's."""
    from tailored_avsr_tpu.decode.streaming import TimesyncStreamer as JaxStreamer
    from tailored_avsr_tpu_torch.decode.ctc_timesync import ctc_timesync_beam_search
    from tailored_avsr_tpu_torch.decode.streaming import TimesyncStreamer

    jm, variables, pm, feats = _pair(seed=9, t=203)
    with torch.no_grad():
        enc, lens, _ = pm.encode(torch.from_numpy(feats), torch.full((2,), 203))
        wt, wl, _, _ = ctc_timesync_beam_search(pm.ctc.log_softmax(enc), lens, beam_size=4, pre_beam=4,
                                                max_len=60, penalty=0.2)
    cuts = [0, 60, 120, 203]
    st = TimesyncStreamer(pm, beam_size=4, pre_beam=4, penalty=0.2, max_tokens=60)
    jst = JaxStreamer(jm, variables, beam_size=4, pre_beam=4, penalty=0.2, max_tokens=60)
    st.reset(2)
    jst.reset(2)
    partials = []
    for a, b in zip(cuts, cuts[1:]):
        partials.append(st.accept(feats[:, a:b]))
        assert partials[-1] == [[int(x) for x in h] for h in jst.accept(feats[:, a:b])]
    final = st.finalize()
    assert final == [[int(x) for x in wt[i, 0, :int(wl[i, 0])]] for i in range(2)]
    assert final == [[int(x) for x in h] for h in jst.finalize()]
    assert any(p[0] for p in partials)
    toks, tlens, scores = st.nbest()
    jtoks, jlens, jscores = jst.nbest()
    np.testing.assert_array_equal(tlens, jlens)
    np.testing.assert_allclose(scores, jscores, atol=1e-3, rtol=0)
