"""The port's Branchformer family against the JAX package, in f32 on the CPU:
the Branchformer layer (every merge, single-branch layers), the encoder
(every input layer the port builds), the ASR and VSR models (CTC log-probs,
greedy ids, ``Speech2Text.greedy`` and ``nbest`` with a tiny LM, the hybrid
loss and every gradient) and the conventional AVSR encoder; stochastic
depth and branch drop by their statistics.

Sizes are the tiny flagship's (output 64, FFN / cgMLP 96, kernel 7, 2
encoder and 2 decoder blocks); inputs from ``np.random.RandomState``. The
JAX side runs its plain path (no Pallas kernel is on a Branchformer
layer's CPU path), the port its kernels' plain versions, with the JAX
weights carried over by the key-grammar export and a strict load.

Tolerances: layer and encoder outputs 1e-4 abs on valid frames; learned
branch weights 1e-5 abs; CTC log-probs and beam scores 1e-4 abs; greedy
and beam ids equal; the hybrid loss 1e-5 relative; each gradient within
1e-4 of its tensor's largest JAX entry plus 1e-5 of the model's largest
(an absolute floor for tensors whose exact gradient is 0, such as the
pooling projections' biases under their softmax).
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.utils.config import load_config
from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
from test_torch_port_ops import jax_module
from test_torch_port_slice import TOKENS, _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN_LIST = [line.rstrip() for line in open(TOKENS) if line.rstrip()]
ASR = "configs/ASR/branchformer_transformer+ctc_spanish.yaml"
VSR = "configs/VSR/conv3dresnet18_branchformer_transformer+ctc_spanish.yaml"
CONVENTIONAL = "configs/AVSR/conventional_transformer+ctc_spanish.yaml"
TINY = dict(output_size=64, linear_units=96, cgmlp_linear_units=96, cgmlp_conv_kernel=7, num_blocks=2)
LM_TINY = dict(att_unit=32, head=4, unit=40, layer=2, embed_unit=16, pos_enc=None, dropout_rate=0.0)
D = 64


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test (the suite runs in several processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _load(module, variables, prefix: str):
    """JAX variables of a sub-tree exported under the key grammar, the
    ``prefix`` stripped, loaded strictly."""
    sd = export_torch_state_dict(variables)
    sd = {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _weights_close(got, want, atol=1e-5):
    """``branch_weights`` lists: the same layers, each weight within atol."""
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, ga), (_, wa) in zip(got, want):
        assert set(ga) == set(wa)
        for key in wa:
            if isinstance(wa[key], dict):  # conventional: per modality
                for sub in wa[key]:
                    np.testing.assert_allclose(ga[key][sub].numpy(), np.asarray(wa[key][sub]), atol=atol)
            else:
                np.testing.assert_allclose(ga[key].numpy(), np.asarray(wa[key]), atol=atol)


# ---------------------------------------------------------------- layer

LAYER_CASES = {
    "concat": dict(merge_method="concat"),
    "learned_ave": dict(merge_method="learned_ave"),
    "fixed_ave_0.3": dict(merge_method="fixed_ave", cgmlp_weight=0.3),
    "fixed_ave_0.0": dict(merge_method="fixed_ave", cgmlp_weight=0.0),  # attention only, merge_proj kept
    "fixed_ave_1.0": dict(merge_method="fixed_ave", cgmlp_weight=1.0),  # cgMLP only, merge_proj kept
    "attn_off": dict(merge_method="learned_ave", use_attn=False),
    "cgmlp_off": dict(merge_method="learned_ave", use_cgmlp=False),
}


@pytest.mark.parametrize("lengths", [(9, 5, 0), (7,)], ids=["odd_and_empty", "b1"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case, lengths):
    """Output within 1e-4 on valid frames, finite everywhere (the length-0
    utterance pools to 0, not NaN); learned weights within 1e-5; the
    parameter names are the JAX export's (a strict load)."""
    from tailored_avsr_tpu.models.branchformer import BranchformerEncoderLayer as J
    from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoderLayer as P

    kw = dict(LAYER_CASES[case])
    rs = np.random.RandomState(len(lengths) + len(case))
    b, t = len(lengths), max(max(lengths), 7)
    x = rs.randn(b, t, D).astype(np.float32)
    pos = rs.randn(1, 2 * t - 1, D).astype(np.float32)
    mask = np.arange(t)[None] < np.asarray(lengths)[:, None]
    common = dict(attention_heads=4, cgmlp_linear_units=96, cgmlp_conv_kernel=7, linear_units=96, dropout_rate=0.0)
    jl = J(size=D, name="layer_0", **common, **kw)
    variables = jax_module(jl, x, pos, mask)
    want, want_aux = jl.apply(variables, x, pos, mask)
    pl = _load(P(D, **common, **kw), {c: {"layer_0": v} for c, v in variables.items()}, "encoders.0.")
    with torch.no_grad():
        got, got_aux = pl(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], atol=1e-4)
    assert set(got_aux) == set(want_aux) == ({"weight_global", "weight_local"} if case == "learned_ave" else set())
    for key in want_aux:
        assert torch.isfinite(got_aux[key]).all()
        np.testing.assert_allclose(got_aux[key].numpy(), np.asarray(want_aux[key]), atol=1e-5)
    if case in ("fixed_ave_0.0", "fixed_ave_1.0"):  # one branch built, merge_proj kept
        assert pl.merge_proj is not None and pl.use_attn != pl.use_cgmlp


def test_attention_pooled_weight_of_an_empty_utterance_is_zero_pooled():
    """All frames masked: a uniform softmax zeroed back, so the pooled vector
    is 0 and the logit is the weight projection's bias, in bf16 too."""
    from tailored_avsr_tpu_torch.models.branchformer import attention_pooled_weight

    pool, proj = torch.nn.Linear(D, 1), torch.nn.Linear(D, 1)
    x = torch.randn(2, 5, D)
    mask = torch.tensor([[True] * 5, [False] * 5])
    for dtype in (torch.float32, torch.bfloat16):
        out = attention_pooled_weight(x.to(dtype), mask, pool.to(dtype), proj.to(dtype), D)
        assert torch.isfinite(out).all() and out.dtype == dtype
        assert out[1, 0] == proj.bias[0]


# ---------------------------------------------------------------- encoder

ENCODER_CASES = {
    # input layer, encoder keys, lengths
    "conv2d_learned_ave": ("conv2d", dict(merge_method="learned_ave"), (41, 30, 0)),
    "conv2d_concat_b1": ("conv2d", dict(merge_method="concat"), (37,)),
    "conv3dresnet18_fixed_list": ("conv3dresnet18", dict(merge_method="fixed_ave", cgmlp_weight=(0.0, 1.0)),
                                  (9, 6)),
    "conv3dresnet18_learned_ave": ("conv3dresnet18", dict(merge_method="learned_ave"), (9, 0, 5)),
    # the other input layers the port builds from its existing ops
    "conv2d6_learned_ave": ("conv2d6", dict(merge_method="learned_ave"), (43, 30)),
    "linear_fixed_ave": ("linear", dict(merge_method="fixed_ave", cgmlp_weight=0.3), (9, 4)),
    "conv1d_concat": ("conv1d", dict(merge_method="concat"), (8, 7)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_matches_jax(case):
    """Output within 1e-4 on valid frames, lengths equal, branch weights
    within 1e-5, finite everywhere."""
    from tailored_avsr_tpu.models.branchformer import BranchformerEncoder as J
    from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder as P

    input_layer, kw, lengths = ENCODER_CASES[case]
    feat = 512 if input_layer in ("conv3dresnet18", "conv1d") else 80
    rs = np.random.RandomState(len(case))
    x = rs.randn(len(lengths), max(lengths), feat).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    conf = dict(TINY, attention_heads=4, input_layer=input_layer, dropout_rate=0.0, positional_dropout_rate=0.0,
                **kw)
    je = J(**conf, name="encoder")
    variables = jax_module(je, x, lens)
    want, want_lens, want_aux = je.apply(variables, x, lens)
    pe = _load(P(input_size=feat, **conf), {c: {"encoder": v} for c, v in variables.items()}, "encoder.")
    with torch.no_grad():
        got, got_lens, got_aux = pe(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    valid = np.arange(got.shape[1])[None] < np.asarray(want_lens)[:, None]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4)
    _weights_close(got_aux["branch_weights"], want_aux["branch_weights"])
    assert len(got_aux["branch_weights"]) == (2 if kw["merge_method"] == "learned_ave" else 0)


# ---------------------------------------------------------------- ASR / VSR models


def tiny_cfg(path, **encoder):
    """A config of the repo cut to the tiny sizes, every rate at 0 and no
    SpecAug (so train mode and eval are the same function)."""
    cfg = load_config(os.path.join(ROOT, path))
    cfg.token_list = TOKENS
    zero = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
    cfg.encoder_conf = dict(cfg.encoder_conf, attention_dropout_rate=0.0, **TINY, **zero, **encoder)
    cfg.decoder_conf = dict(cfg.decoder_conf, linear_units=96, num_blocks=2, self_attention_dropout_rate=0.0,
                            src_attention_dropout_rate=0.0, **zero)
    cfg.ctc_conf = dict(cfg.ctc_conf, dropout_rate=0.0)
    cfg.specaug = None
    if cfg.task == "avsr":
        cfg.audiovisual_fusion_conf = dict(cfg.audiovisual_fusion_conf, output_size=64, hidden_units=96,
                                           dropout_rate=0.0)
        cfg.acoustic_embed_conf = dict(cfg.acoustic_embed_conf, **zero)
        cfg.visual_embed_conf = dict(cfg.visual_embed_conf, **zero)
    return cfg


def speech_batch(task: str, b: int = 2):
    """asr: 10 frames of 640 samples (encoder T = 9, odd), the second
    utterance 2.5 frames shorter; vsr: 9 lip frames, the second 6."""
    rs = np.random.RandomState(7)
    if task == "asr":
        n = 6400
        speech, lens = (rs.randn(b, n) * 0.1).astype(np.float32), np.array([n, n - 1600], np.int32)[:b]
    else:
        speech, lens = rs.randn(b, 9, 88, 88).astype(np.float32), np.array([9, 6], np.int32)[:b]
    text = rs.randint(3, len(TOKEN_LIST) - 1, (b, 4)).astype(np.int32)
    text[1:, 3:] = -1
    return {"speech": speech, "speech_lengths": lens, "text": text,
            "text_lengths": np.array([4] + [3] * (b - 1), np.int32)}


def _models(path, seed=0, **encoder):
    """(cfg, JAX model, its random variables, the port model on them)."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu_torch.tasks.asr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    cfg = tiny_cfg(path, **encoder)
    jm = ASRTask.build_model(cfg, list(TOKEN_LIST))
    b = speech_batch(cfg.task)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            b["speech"], b["speech_lengths"], b["text"], b["text_lengths"]))
    variables = _random_variables(shapes, seed=seed)
    pm = build_model(cfg, TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    return cfg, jm, variables, pm


@pytest.fixture(scope="module", params=["asr", "vsr"])
def speech_models(request):
    cfg, jm, variables, pm = _models(ASR if request.param == "asr" else VSR, seed=11)
    batch = speech_batch(cfg.task)

    @jax.jit
    def serve(v, speech, lens):
        enc, enc_lens, aux = jm.apply(v, speech, lens, method="encode")
        logp = jm.apply(v, enc, method=lambda m, x: m.ctc.log_softmax(x))
        return logp, enc_lens, jnp.argmax(logp, -1), aux["branch_weights"]

    want = jax.device_get(serve(variables, batch["speech"], batch["speech_lengths"]))
    return {"cfg": cfg, "jax_model": jm, "variables": variables, "port": pm, "batch": batch, "want": want}


def test_speech_model_encode_and_greedy_match_jax(speech_models):
    """CTC log-probs within 1e-4, greedy ids equal on valid frames, branch
    weights within 1e-5."""
    logp, lens, ids, weights = speech_models["want"]
    b = speech_models["batch"]
    pm = speech_models["port"]
    with torch.no_grad():
        got_logp, got_lens = pm.ctc_logprobs(torch.from_numpy(b["speech"]), torch.from_numpy(b["speech_lengths"]))
        got_ids, _ = pm.ctc_greedy(torch.from_numpy(b["speech"]), torch.from_numpy(b["speech_lengths"]))
        _, _, aux = pm.encode(torch.from_numpy(b["speech"]), torch.from_numpy(b["speech_lengths"]))
    np.testing.assert_array_equal(got_lens.numpy(), lens)
    valid = np.arange(logp.shape[1])[None] < lens[:, None]
    np.testing.assert_allclose(got_logp.numpy()[valid], logp[valid], atol=1e-4)
    np.testing.assert_array_equal(got_ids.numpy()[valid], ids[valid])
    _weights_close(aux["branch_weights"], weights)


def test_speech2text_greedy_and_nbest_match_jax(speech_models):
    """``Speech2Text`` of both packages on the same weights, with a tiny
    Transformer LM: greedy transcripts equal; beam 3, nbest 2: ids equal,
    scores within 1e-4."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu.tasks.lm import LMTask
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_lm_variables
    from test_torch_port_beam import _same_nbest

    cfg = copy.deepcopy(speech_models["cfg"])
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=3, nbest=2)
    lm_cfg = types.SimpleNamespace(token_list=None, lm_conf=LM_TINY)
    batch = {k: speech_models["batch"][k] for k in ("speech", "speech_lengths")}
    js = JaxSpeech2Text(cfg, lm_config=lm_cfg)
    js.variables = jax.tree_util.tree_map(jnp.asarray, speech_models["variables"])
    lm = LMTask.build_model(lm_cfg, TOKEN_LIST)
    lm_vars = _random_variables(jax.eval_shape(
        lambda: lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.array([4]))), seed=4)
    js.lm_variables = jax.tree_util.tree_map(jnp.asarray, lm_vars)
    ps = Speech2Text(copy.deepcopy(cfg), lm_config=lm_cfg, device="cpu")
    ps.model.load_state_dict(speech_models["port"].state_dict(), strict=True)
    ps.lm.load_state_dict(convert_jax_lm_variables(lm_vars), strict=True)
    greedy = ps.greedy(batch)
    assert greedy == js.greedy(batch) and len(greedy) == 2
    _same_nbest(ps.nbest(batch), js.nbest(batch))


@pytest.mark.parametrize("path", [ASR, VSR], ids=["asr", "vsr"])
def test_speech_inputs_dequantize_like_jax(path):
    """int16 audio / uint8 lip crops under ``speech`` are dequantised on the
    device as the JAX engine does, with -1 past each utterance's length."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = tiny_cfg(path)
    rs = np.random.RandomState(5)
    speech = (rs.randint(-32768, 32767, (2, 3200)).astype(np.int16) if cfg.task == "asr"
              else rs.randint(0, 256, (2, 5, 88, 88)).astype(np.uint8))
    lens = np.array([speech.shape[1], speech.shape[1] - 2], np.int32)
    want = JaxSpeech2Text(cfg)._dequantize((jnp.asarray(speech), jnp.asarray(lens)))
    got = Speech2Text(cfg, device="cpu").inputs({"speech": speech, "speech_lengths": lens})
    assert len(got) == 2 and got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.fixture(scope="module")
def asr_loss_graph():
    """One JAX compile: the loss, stats and parameter gradients of the tiny
    ASR model with deterministic=True and deterministic=False."""
    cfg, jm, variables, _ = _models(ASR, seed=5, stochastic_depth_rate=0.0, attn_branch_drop_rate=0.0)
    b = speech_batch("asr")
    args = tuple(b[k] for k in ("speech", "speech_lengths", "text", "text_lengths"))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "skip", "specaug"))}

    @jax.jit
    def run(params):
        return [jax.value_and_grad(lambda p: jm.apply({"params": p}, *args, deterministic=det, rngs=rngs),
                                   has_aux=True)(params) for det in (True, False)]

    return {"cfg": cfg, "variables": variables, "args": args, "jax": jax.device_get(run(variables["params"]))}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_mode"])
def test_asr_loss_and_gradients_match_jax(asr_loss_graph, train):
    """The hybrid loss and its terms (rates zeroed: train mode is the eval
    function) within 1e-5 relative, acc exact, branch weights in the stats,
    and every parameter's gradient as the module docstring states."""
    from tailored_avsr_tpu_torch.tasks.asr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    (want_loss, want_stats), want_grads = asr_loss_graph["jax"][int(train)]
    pm = build_model(asr_loss_graph["cfg"], TOKEN_LIST, device="cpu")
    pm.load_state_dict(convert_jax_variables(asr_loss_graph["variables"], pm)[0], strict=True)
    pm.train(train)
    loss, stats = pm(*(torch.from_numpy(a) for a in asr_loss_graph["args"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in ("loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(stats[key].detach()), float(want_stats[key]), rtol=1e-5)
    assert float(stats["acc"]) == float(want_stats["acc"])
    _weights_close([(i, {k: v.detach() for k, v in a.items()}) for i, a in stats["branch_weights"]],
                   want_stats["branch_weights"])
    want = {k: np.asarray(v) for k, v in export_torch_state_dict({"params": want_grads}).items()}
    named = dict(pm.named_parameters())
    assert set(want) == set(named)
    floor = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for name, p in named.items():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=floor + 1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


# ---------------------------------------------------------------- conventional AVSR


def _av_batch(frames: int, audio_frames: int):
    """Two utterances of ``frames`` lip frames (the second one shorter) and
    ``audio_frames`` x 640 samples of audio (the second 640 shorter)."""
    rs = np.random.RandomState(0)
    n = audio_frames * 640
    return ((rs.randn(2, n) * 0.1).astype(np.float32), np.array([n, n - 640], np.int32),
            rs.randn(2, frames, 88, 88).astype(np.float32), np.array([frames, frames - 1], np.int32))


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned_buffers", "audio_one_frame_short"])
def test_conventional_encode_and_greedy_match_jax(aligned):
    """Conventional AVSR (two Branchformer stacks, adaptive fusion): greedy
    ids equal, the per-modality branch weights within 1e-5. Encoder output:
    with the audio buffer as long as the video's (one frame more of audio)
    within 1e-4 on valid frames. With the loader's buffers, the audio one
    encoder frame short, the aligner pads it with rows of -1, whose
    macaron-FFN output meets flax's one-pass LayerNorm variance; the cgMLP
    convolutions carry that into the valid frames (3.8e-4 from an f64 run
    of the port at this batch, 2.4e-5 on the branch weights), so the JAX
    output is held within 2e-3 and its weights within 1e-4 there, and the
    port within 1e-5 of its own f64 run in both cases."""
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    cfg = tiny_cfg(CONVENTIONAL)
    jm = AVSRTask.build_model(cfg, list(TOKEN_LIST))
    args = _av_batch(9, 10 if aligned else 9)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *args, np.ones((2, 4), np.int32), np.full((2,), 4, np.int32)))
    variables = _random_variables(shapes, seed=2)

    @jax.jit
    def serve(v, *a):
        enc, lens, aux = jm.apply(v, *a, method="encode")
        return enc, lens, jm.apply(v, enc, method=lambda m, x: m.ctc.argmax(x)), aux["branch_weights"]

    enc, lens, ids, weights = jax.device_get(serve(variables, *args))
    pm = build_model(cfg, TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, got_lens, aux = pm.encode(*(torch.from_numpy(a) for a in args))
        got_ids, _ = pm.ctc_greedy(*(torch.from_numpy(a) for a in args))
        f64, _, aux64 = pm.double().encode(*(torch.from_numpy(a).double() if a.dtype == np.float32
                                             else torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got_lens.numpy(), lens)
    valid = np.arange(got.shape[1])[None] < lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], f64.numpy()[valid], atol=1e-5)
    np.testing.assert_allclose(got.numpy()[valid], enc[valid], atol=1e-4 if aligned else 2e-3)
    np.testing.assert_array_equal(got_ids.numpy()[valid], ids[valid])
    _weights_close(aux["branch_weights"], aux64["branch_weights"])
    _weights_close(aux["branch_weights"], weights, atol=1e-5 if aligned else 1e-4)
    assert [set(a) for _, a in aux["branch_weights"]] == [{"acoustic", "visual"}] * 2


# ---------------------------------------------------------------- random streams


def test_stochastic_depth_and_branch_drop_rates():
    """Stochastic depth skips the layer (input returned, no aux) with
    probability p, and a kept layer scales its merge residual by 1 / (1 - p);
    branch drop sets the learned weights to (0, 1) with probability q. 300
    steps each: rates within 5 standard deviations; eval draws no coin."""
    from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoderLayer
    from tailored_avsr_tpu_torch.utils.initialize import init_params_

    x, pos = torch.randn(2, 6, D), torch.randn(1, 11, D)
    mask = torch.ones(2, 6, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    for p, q in ((0.3, 0.0), (0.0, 0.4)):
        layer = BranchformerEncoderLayer(D, linear_units=96, cgmlp_linear_units=96, cgmlp_conv_kernel=7,
                                         dropout_rate=0.0, stochastic_depth_rate=p, attn_branch_drop_rate=q)
        init_params_(layer, torch.Generator().manual_seed(1)).train()
        skipped = dropped = 0
        with torch.no_grad():
            for _ in range(300):
                out, aux = layer(x, pos, mask, g)
                skipped += int(out is x and not aux)
                if aux:
                    w1, w2 = aux["weight_global"], aux["weight_local"]
                    drop = bool((w1 == 0).all() and (w2 == 1).all())
                    assert drop or bool((w1 > 0).all())
                    dropped += int(drop)
            rate, want = (skipped, p) if p else (dropped, q)
            assert abs(rate / 300 - want) < 5 * (want * (1 - want) / 300) ** 0.5
            layer.eval()
            assert layer(x, pos, mask, g)[0] is not x and layer(x, pos, mask, g)[1]["weight_global"].gt(0).all()
    # the coefficient: the same kept layer at p = 0 and p = 0.5 differs
    layer = BranchformerEncoderLayer(D, linear_units=96, cgmlp_linear_units=96, cgmlp_conv_kernel=7,
                                     dropout_rate=0.0)
    init_params_(layer, torch.Generator().manual_seed(1)).train()
    with torch.no_grad():
        base = layer(x, pos, mask, torch.Generator().manual_seed(0))[0]
        layer.stochastic_depth_rate = 0.5
        out = next(o for o, _ in (layer(x, pos, mask, torch.Generator().manual_seed(s)) for s in range(20))
                   if o is not x)
    assert not torch.allclose(out, base)
