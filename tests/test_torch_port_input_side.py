"""The rest of the input side and PIT, the port against the JAX package in
f32 on the CPU.

- Modules: the sliding-window frontend (bit for bit, the input dtype
  kept), the fused frontend (log-mel + sliding window, their projections;
  the gated sub-frontends refused in both packages), global MVN with its
  ``stats`` carried across by the port's export, utterance MVN with
  ``norm_vars``, the linear pre- and post-encoders.
- The ASR model with all of them (fused frontend, global MVN, both
  pre/post-encoders at another width than the encoder): encoder output,
  CTC log-probs and the hybrid loss against JAX; the port's export against
  the JAX export (the ``stats`` collection the port's alone).
- The multi-speaker encoder's shape and values, and the PIT model's loss,
  its per-utterance permutation, ``ctc_argmax`` and gradients against JAX;
  the loss unchanged when the references are swapped.
- ``compute_global_mvn_stats`` against the JAX script on the synthetic
  corpus.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
from test_torch_port_branchformer import ASR, TOKEN_LIST, speech_batch, tiny_cfg
from test_torch_port_ops import close, load_port, t
from test_torch_port_slice import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = {"frontends": [{"frontend_type": "default", "n_mels": 24, "hop_length": 160},
                       {"frontend_type": "sliding_window", "win_length": 400, "hop_length": 80}],
         "proj_dim": 20}
_ABS = dict(attention_layer_type="selfattn", pos_enc_layer_type="abs_pos")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _audio(b=2, n=6400, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n) * 0.1).astype(np.float32), np.array([n, n - 1700], np.int32)[:b]


# ---------------------------------------------------------------- modules


def test_sliding_window_frontend():
    """A pure gather: equal to JAX's frames bit for bit, the same lengths
    (at least 0), and a bf16 input stays bf16."""
    from tailored_avsr_tpu.ops.frontend_audio import SlidingWindowFrontend as J
    from tailored_avsr_tpu_torch.ops.frontend_audio import SlidingWindowFrontend as P

    x, lens = _audio()
    lens = np.array([6400, 300], np.int32)  # the second shorter than a window: 0 frames
    want, want_lens = J(400, 160).apply({}, x, lens)
    got, got_lens = P(400, 160)(t(x), t(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert P(400, 160).output_size() == 400 and P()(t(x).to(torch.bfloat16), t(lens))[0].dtype == torch.bfloat16


def test_fused_frontend():
    """Log-mel (hop 160) beside a sliding window (hop 80): gcd 80, factors 2
    and 1, ``proj0`` / ``proj1``, cut to the shortest stream; within 1e-4
    of JAX (the log-mel's own tolerance), lengths equal; the gated
    sub-frontends refused in both packages."""
    from tailored_avsr_tpu.ops.frontend_audio import FusedFrontend as J
    from tailored_avsr_tpu_torch.ops.frontend_audio import FusedFrontend as P

    x, lens = _audio()
    subs = tuple(dict(f) for f in FUSED["frontends"])
    jm = J(frontends=subs, proj_dim=20)
    variables = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), lens)), 1)
    want, want_lens = jax.jit(lambda v, a: jm.apply(v, a, lens))(variables, x)  # traced audio: JAX's gather needs it
    pm = load_port(P(subs, proj_dim=20), variables, "frontend")
    assert pm.factors == (2, 1) and pm.output_size() == 40 and pm.proj0.out_features == 40
    with torch.no_grad():
        got, got_lens = pm(t(x), t(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got, want, atol=1e-4, rtol=1e-4)
    bad = ({"frontend_type": "s3prl"},)
    with pytest.raises(NotImplementedError, match="pretrained"):
        P(bad)
    with pytest.raises(NotImplementedError, match="pretrained"):
        J(frontends=bad).init(jax.random.PRNGKey(0), jnp.asarray(x), lens)


@pytest.mark.parametrize("means,var", [(True, True), (True, False), (False, True)])
def test_global_mvn_with_its_stats(means, var):
    """The JAX ``stats`` collection goes across through the port's export
    into the buffers (``normalize.mean`` / ``normalize.std``): outputs equal
    to JAX's in f32, and in bf16 the statistics cast to the input's dtype
    as JAX casts them."""
    from tailored_avsr_tpu.ops.normalize import GlobalMVN as J
    from tailored_avsr_tpu_torch.ops.normalize import GlobalMVN as P
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict as port_export

    rs = np.random.RandomState(4)
    x = (rs.randn(2, 9, 6) * 2 + 1).astype(np.float32)
    lens = np.array([9, 5], np.int32)
    stats = {"mean": rs.randn(6).astype(np.float32), "std": (0.5 + rs.rand(6)).astype(np.float32)}
    jm = J(feature_size=6, norm_means=means, norm_vars=var)
    variables = {"stats": stats}
    sd = port_export({"stats": {"normalize": stats}})
    assert sorted(sd) == ["normalize.mean", "normalize.std"] and export_torch_state_dict(
        {"stats": {"normalize": stats}}) == {}  # the JAX export drops the collection
    pm = P(6, norm_means=means, norm_vars=var)
    pm.load_state_dict({k.split(".")[1]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want, _ = jm.apply(variables, jnp.asarray(x, jdt), lens)
        got, _ = pm(t(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(dtype), t(lens))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_pre_and_post_encoders():
    from tailored_avsr_tpu.models.prepostencoder import LinearPostencoder as JPost
    from tailored_avsr_tpu.models.prepostencoder import LinearProjection as JPre
    from tailored_avsr_tpu_torch.models.prepostencoder import LinearPostencoder, LinearProjection

    x = np.random.RandomState(5).randn(2, 7, 12).astype(np.float32)
    lens = np.array([7, 3], np.int32)
    for jm, pm, root in ((JPre(output_size=9), LinearProjection(12, 9), "preencoder"),
                         (JPost(output_size=9), LinearPostencoder(12, 9), "postencoder")):
        variables = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lens)), 2)
        want, want_lens = jm.apply(variables, x, lens)
        got, got_lens = load_port(pm, variables, root)(t(x), t(lens))
        close(got, want)
        assert got_lens is not None and np.array_equal(got_lens.numpy(), np.asarray(want_lens))


# ---------------------------------------------------------------- the ASR model


def _models(cfg, seed, refs=None):
    """(JAX model, its random variables (stats drawn apart), the port model
    on them, batch: with ``refs``, ``refs`` target rows an utterance)."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    jm = ASRTask.build_model(cfg, list(TOKEN_LIST))
    b = speech_batch("asr")
    if refs:
        rs = np.random.RandomState(seed)
        b["text"] = rs.randint(3, len(TOKEN_LIST) - 1, (2, refs, 4)).astype(np.int32)
        b["text_lengths"] = np.array([[4, 2, 3][:refs], [3, 4, 1][:refs]], np.int32)
        b["text"][np.arange(4)[None, None] >= b["text_lengths"][..., None]] = -1
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(b["speech"]),
                                            b["speech_lengths"], b["text"], b["text_lengths"]))
    variables = _random_variables(shapes, seed=seed)
    if "stats" in variables:
        rs = np.random.RandomState(seed)
        n = variables["stats"]["normalize"]["mean"].shape[0]
        variables["stats"] = {"normalize": {"mean": rs.randn(n).astype(np.float32),
                                            "std": (0.5 + rs.rand(n)).astype(np.float32)}}
    pm = build_model(cfg, TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    return jm, variables, pm.eval(), b


def _input_side_cfg(normalize="global_mvn", **normalize_conf):
    cfg = tiny_cfg(ASR)
    cfg.frontend, cfg.frontend_conf = "fused", FUSED
    cfg.normalize, cfg.normalize_conf = normalize, normalize_conf
    cfg.preencoder, cfg.preencoder_conf = "linear", {"output_size": 32}
    cfg.postencoder, cfg.postencoder_conf = "linear", {"output_size": 48}
    return cfg


@pytest.mark.parametrize("normalize", ["global_mvn", "utterance_mvn_norm_vars"])
def test_asr_model_with_the_whole_input_side_matches_jax(normalize):
    """Fused frontend, global MVN (or utterance MVN with ``norm_vars``), a
    40 -> 32 pre-encoder, the 64-wide Branchformer, a 64 -> 48
    post-encoder whose width the CTC head and the decoder's cross-attention
    read: the encoder output, CTC log-probs and greedy ids, and the hybrid
    loss and its gradients, against JAX."""
    cfg = _input_side_cfg("global_mvn") if normalize == "global_mvn" else _input_side_cfg(
        "utterance_mvn", norm_means=True, norm_vars=True)
    jm, variables, pm, b = _models(cfg, 11)
    assert pm.decoder.decoders[0].src_attn.linear_k.in_features == 48 and pm.ctc.ctc_lo.in_features == 48
    args = (b["speech"], b["speech_lengths"])
    loss_args = args + (b["text"], b["text_lengths"])

    @jax.jit
    def run(params, speech):  # one compile: the encode, its CTC log-probs, the loss and its gradients
        v = dict(variables, params=params)
        enc, enc_lens, _ = jm.apply(v, speech, args[1], method="encode")
        logp = jm.apply(v, enc, method=lambda m, x: m.ctc.log_softmax(x))
        return (enc, enc_lens, logp), jax.value_and_grad(
            lambda p: jm.apply(dict(variables, params=p), speech, *loss_args[1:]), has_aux=True)(params)

    (want, want_lens, want_logp), ((want_loss, want_stats), grads) = jax.device_get(
        run(variables["params"], args[0]))
    with torch.no_grad():
        got, got_lens, _ = pm.encode(t(args[0]), t(args[1]))
        logp = pm.ctc.log_softmax(got)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got, want, atol=1e-4)
    close(logp, want_logp, atol=1e-4)
    loss, stats = pm(*(t(a) for a in loss_args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(stats["loss_att"].detach()), float(want_stats["loss_att"]), rtol=1e-5)
    want_g = export_torch_state_dict({"params": grads})
    for name, p in pm.named_parameters():
        w = np.asarray(want_g[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=2e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def test_the_new_trees_export_as_the_jax_export():
    """The port's export copy equals the JAX export key for key and array for
    array over the input side's, the streaming encoder's and the PIT
    model's trees; with the ``stats`` collection it adds exactly
    ``normalize.mean`` / ``normalize.std``."""
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict as port_export

    cfgs = [_input_side_cfg()]
    cfg = tiny_cfg(ASR)
    cfg.encoder, cfg.encoder_conf = "contextual_block_conformer", dict(cfg.encoder_conf, **_ABS, block_size=6,
                                                                       hop_size=2, cnn_module_kernel=5)
    cfgs.append(cfg)
    cfg = tiny_cfg(ASR)
    cfg.model, cfg.encoder, cfg.encoder_conf = "pit_espnet", "transformer_multispkr", dict(cfg.encoder_conf, **_ABS)
    cfgs.append(cfg)
    for cfg in cfgs:
        _, variables, _, _ = _models(cfg, 12, refs=2 if cfg.model == "pit_espnet" else None)
        plain = {k: v for k, v in variables.items() if k != "stats"}
        got, want = port_export(plain), export_torch_state_dict(plain)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        extra = sorted(set(port_export(variables)) - set(got))
        assert extra == (["normalize.mean", "normalize.std"] if "stats" in variables else [])


# ---------------------------------------------------------------- PIT


def _pit_cfg(num=2, ctc_weight=0.3):
    cfg = tiny_cfg(ASR)
    cfg.model, cfg.encoder = "pit_espnet", "transformer_multispkr"
    cfg.encoder_conf = dict(cfg.encoder_conf, **_ABS, num_inf=num, num_blocks_sd=1)
    cfg.model_conf = dict(cfg.model_conf, num_inf=num, num_ref=num, ctc_weight=ctc_weight)
    return cfg


def test_multispeaker_encoder_matches_jax():
    """Shared layers, then a stack per speaker (``sd{s}_layer_{i}``): (B,
    num_inf, T, D) within 1e-5 of JAX, the same lengths."""
    jm, variables, pm, b = _models(_pit_cfg(3), 13, refs=3)
    args = (b["speech"], b["speech_lengths"])
    want, want_lens, _ = jax.jit(lambda v: jm.apply(v, *args, method="encode"))(variables)
    with torch.no_grad():
        got, got_lens, _ = pm.encode(t(args[0]), t(args[1]))
    assert got.shape == want.shape and got.shape[1] == 3
    assert hasattr(pm.encoder, "sd2_layer_0") and not hasattr(pm.encoder, "sd0_layer_1")
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("num", [2, 3])
def test_pit_loss_argmax_and_gradients_match_jax(num):
    """The (S_inf, S_ref, B) CTC pair losses, the permutation each utterance
    picks, the CTC and attention losses, ``ctc_argmax`` (B, S, T) and every
    gradient against JAX; swapping the references leaves the loss within
    1e-6 relative."""
    from tailored_avsr_tpu.models.pit_model import PITASRModel as JaxPIT

    jm, variables, pm, b = _models(_pit_cfg(num), 14 + num, refs=num)
    assert isinstance(jm, JaxPIT)
    args = (b["speech"], b["speech_lengths"], b["text"], b["text_lengths"])

    @jax.jit
    def run(params):
        return jax.value_and_grad(lambda p: jm.apply({"params": p}, *args, return_ctc_argmax=True),
                                  has_aux=True)(params)

    (want_loss, want_stats), grads = jax.device_get(run(variables["params"]))
    loss, stats = pm(*(t(a) for a in args), return_ctc_argmax=True)
    loss.backward()
    for key in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(stats[key].detach()), float(want_stats[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(stats["ctc_argmax"].numpy(), np.asarray(want_stats["ctc_argmax"]))
    assert stats["ctc_argmax"].shape[:2] == (2, num)
    want_g = export_torch_state_dict({"params": grads})
    for name, p in pm.named_parameters():
        w = np.asarray(want_g[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=2e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    order = np.roll(np.arange(num), 1)  # every reference moves
    with torch.no_grad():
        swapped, _ = pm(t(args[0]), t(args[1]), t(args[2][:, order]), t(args[3][:, order]))
    np.testing.assert_allclose(float(swapped), float(loss.detach()), rtol=1e-6)


def test_pit_model_is_not_served():
    """The engine decodes single-speaker models: ``greedy`` and ``nbest`` of a
    ``pit_espnet`` config raise TypeError, as the JAX engine's decode
    fails on its (B, num_inf, T, D) encoder output with one."""
    import copy

    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = _pit_cfg()
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=2, nbest=1, unroll=1)
    _, variables, pm, b = _models(cfg, 16, refs=2)
    batch = {k: b[k] for k in ("speech", "speech_lengths")}
    ps = Speech2Text(copy.deepcopy(cfg), device="cpu")
    js = JaxSpeech2Text(copy.deepcopy(cfg))
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    for call in (ps.greedy, ps.nbest, js.greedy):
        with pytest.raises(TypeError):
            call(batch)


# ---------------------------------------------------------------- the stats script


def test_global_mvn_stats_script_matches_the_jax_script(tmp_path):
    """``python -m tailored_avsr_tpu_torch.compute_global_mvn_stats`` against
    ``scripts/compute_global_mvn_stats.py`` on the synthetic corpus: the
    same arrays within the log-mel's 1e-4."""
    import importlib.util

    from synthetic import make_synthetic_corpus
    from tailored_avsr_tpu_torch import compute_global_mvn_stats

    split, _ = make_synthetic_corpus(str(tmp_path / "corpus"), n=4)
    spec = importlib.util.spec_from_file_location("jax_stats", os.path.join(ROOT, "scripts/compute_global_mvn_stats.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jax_script.main(["--dataset", split, "--output", str(tmp_path / "jax.npz"), "--n-mels", "40"])
    compute_global_mvn_stats.main(["--dataset", split, "--output", str(tmp_path / "port.npz"), "--n-mels", "40",
                                   "--device", "cpu"])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    for key in ("mean", "std"):
        assert got[key].dtype == np.float32 and got[key].shape == (40,)
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
