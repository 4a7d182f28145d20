"""Each module of the PyTorch port's serving slice against its JAX module.

Same inputs (``np.random.RandomState``) and the same weights go through the
JAX module and its counterpart in ``tailored_avsr_tpu_torch``, in f32 on the
CPU. Weights flow through the JAX package's ``export_torch_state_dict`` and
load into the port with ``load_state_dict(strict=True)``; they are perturbed
first, so that zero biases or identity BN statistics hide no layout or
naming error. Tolerances: about 1e-5 abs per op (f32 rounding in sums of
tens to thousands of terms taken in another order), 1e-4 relative for the
log-mel (the two FFTs sum in different orders).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def perturb(variables, seed=42):
    """Every float leaf + 0.05 N(0, 1); BN variances kept positive."""
    rs = np.random.RandomState(seed)

    def walk(tree, collection):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, collection)
                continue
            v = np.asarray(v, np.float32)
            v = v + 0.05 * rs.randn(*v.shape).astype(np.float32)
            out[k] = np.abs(v) + 0.1 if k == "var" else v
        return out

    return {c: walk(t, c) for c, t in variables.items()}


def load_port(module: torch.nn.Module, variables, root: str):
    """Export JAX ``variables`` as if they sat under model attribute ``root``
    (the key grammar depends on it), strip that prefix and load strictly."""
    sd = export_torch_state_dict({c: {root: t} for c, t in variables.items()})
    prefix = root + "."
    sd = {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    for k, v in module.state_dict().items():  # torch-only BN counters
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros_like(v)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def jax_module(module, *args, **kw):
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)
    return perturb(jax.tree_util.tree_map(np.asarray, variables))


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), atol=atol, rtol=rtol,
    )


def test_make_valid_mask():
    from tailored_avsr_tpu.ops.masking import make_valid_mask as jmask
    from tailored_avsr_tpu_torch.ops.masking import make_valid_mask, mask_lengths

    lens = np.array([0, 3, 7], np.int32)
    m = make_valid_mask(t(lens), 7)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask(jnp.asarray(lens), 7)))
    np.testing.assert_array_equal(mask_lengths(m).numpy(), lens)


@pytest.mark.parametrize("activation", ["swish", "relu", "gelu"])
def test_feed_forward(activation):
    from tailored_avsr_tpu.ops.feedforward import PositionwiseFeedForward as J
    from tailored_avsr_tpu_torch.ops.feedforward import PositionwiseFeedForward as P

    x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
    jm = J(24, 0.0, activation)
    v = jax_module(jm, x)
    pm = load_port(P(16, 24, 0.0, activation), v, "ffn")
    with torch.no_grad():
        close(pm(t(x)), jm.apply(v, x))


def test_log_mel_frontend():
    from tailored_avsr_tpu.ops.frontend_audio import LogMelFrontend as J
    from tailored_avsr_tpu_torch.ops.frontend_audio import LogMelFrontend as P

    rs = np.random.RandomState(1)
    audio = (rs.randn(2, 4000) * 0.1).astype(np.float32)
    lens = np.array([4000, 3111], np.int32)
    want, want_lens = J().apply({}, audio, lens)
    got, got_lens = P()(t(audio), t(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    # log of power sums over 512-point FFTs taken in another order
    close(got, want, atol=1e-4, rtol=1e-4)


def test_utterance_mvn():
    from tailored_avsr_tpu.ops.normalize import UtteranceMVN as J
    from tailored_avsr_tpu_torch.ops.normalize import UtteranceMVN as P

    x = np.random.RandomState(2).randn(3, 9, 8).astype(np.float32) + 3.0
    lens = np.array([9, 4, 1], np.int32)
    want, _ = J().apply({}, x, lens)
    got, _ = P()(t(x), t(lens))
    close(got, want)
    # norm_vars (once refused): each utterance's deviation divided out, with
    # and without the means (a 1-frame utterance's variance is 0: eps)
    for means in (True, False):
        want, _ = J(norm_means=means, norm_vars=True).apply({}, x, lens)
        got, _ = P(norm_means=means, norm_vars=True)(t(x), t(lens))
        close(got, want)


def test_conv2d_subsampling():
    from tailored_avsr_tpu.ops.subsampling import Conv2dSubsampling as J
    from tailored_avsr_tpu.ops.subsampling import subsampled_length as jlen
    from tailored_avsr_tpu_torch.ops.subsampling import Conv2dSubsampling as P
    from tailored_avsr_tpu_torch.ops.subsampling import subsampled_length

    x = np.random.RandomState(3).randn(2, 37, 80).astype(np.float32)
    jm = J(32, 4)
    v = jax_module(jm, x)
    # the AVSR embeds hold it as ``embed_conv`` (reference key ``embed.conv.{2j}``)
    holder = torch.nn.Module()
    holder.embed = P(80, 32, 4)
    load_port(holder, {c: {"embed_conv": tr} for c, tr in v.items()}, "acoustic_embed")
    with torch.no_grad():
        close(holder.embed(t(x)), jm.apply(v, x))
    for n in (7, 37, 2001):
        assert subsampled_length(n, 4) == jlen(n, 4)


def test_rel_positional_encoding():
    from tailored_avsr_tpu.ops.posenc import RelPositionalEncoding as J
    from tailored_avsr_tpu_torch.ops.posenc import RelPositionalEncoding as P

    x = np.random.RandomState(4).randn(2, 6, 16).astype(np.float32)
    want_x, want_pos = J(0.0).apply({}, x)
    got_x, got_pos = P(0.0)(t(x))
    close(got_x, want_x)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))


def test_rel_shift():
    from tailored_avsr_tpu.ops.attention import rel_shift as J
    from tailored_avsr_tpu_torch.ops.attention import rel_shift as P

    x = np.random.RandomState(5).randn(2, 3, 7, 13).astype(np.float32)
    np.testing.assert_array_equal(P(t(x)).numpy(), np.asarray(J(jnp.asarray(x))))


@pytest.mark.parametrize("route", ["eager", "k2", "k1"])
def test_rel_pos_attention(route, monkeypatch):
    """Eager JAX attention vs the port's three routes; on the CPU the flash
    routes run the kernels' plain versions. ``k1`` lowers the bias-size switch
    so the in-kernel rel-pos route runs at a small T."""
    from tailored_avsr_tpu.ops.attention import RelPositionMultiHeadedAttention as J
    from tailored_avsr_tpu.ops.posenc import rel_pos_table
    from tailored_avsr_tpu_torch.ops import attention as pattn

    if route == "k1":
        monkeypatch.setattr(pattn, "FLASH_RELPOS_MIN_BIAS_BYTES", 0)
    rs = np.random.RandomState(6)
    x = rs.randn(2, 13, 32).astype(np.float32)
    pos = rel_pos_table(13, 32)[None]
    mask = np.arange(13)[None, :] < np.array([13, 9])[:, None]
    jm = J(num_heads=4)
    v = jax_module(jm, x, x, x, pos, mask)
    pm = load_port(pattn.RelPositionMultiHeadedAttention(32, 4, use_flash=route != "eager"), v, "attn")
    with torch.no_grad():
        got = pm(t(x), t(x), t(x), t(pos), t(mask))
    close(got, jm.apply(v, x, x, x, pos, mask))


@pytest.mark.parametrize("fused", [False, True])
def test_cgmlp(fused):
    """JAX eager cgMLP vs the port's eager gate and its fused route (the K3
    plain version on the CPU)."""
    from tailored_avsr_tpu.ops.cgmlp import ConvolutionalGatingMLP as J
    from tailored_avsr_tpu_torch.ops.cgmlp import ConvolutionalGatingMLP as P

    x = np.random.RandomState(7).randn(2, 11, 16).astype(np.float32)
    jm = J(linear_units=24, kernel_size=5)
    v = jax_module(jm, x)
    pm = load_port(P(16, 24, 5, use_fused=fused), v, "cgmlp")
    with torch.no_grad():
        close(pm(t(x)), jm.apply(v, x))


def test_conv3d_resnet18():
    """Plain Conv3d stem (port) vs the JAX space-to-depth stem (same weights),
    BasicBlocks with downsampling, BN in eval mode, global pool."""
    from tailored_avsr_tpu.models.frontends import Conv3dResNet18 as J
    from tailored_avsr_tpu_torch.models.frontends import Conv3dResNet18 as P

    video = np.random.RandomState(8).randn(1, 3, 32, 32).astype(np.float32)
    lens = np.array([3], np.int32)
    jm = J()
    v = jax_module(jm, video, lens)
    pm = load_port(P(), v, "visual_frontend")
    want, _ = jm.apply(v, video, lens)
    with torch.no_grad():
        got, got_lens = pm(t(video), t(lens))
    np.testing.assert_array_equal(got_lens.numpy(), lens)
    # 22 convolutions in f32: relative to the output's scale
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, atol=1e-5 * scale)


@pytest.mark.parametrize("input_layer,idim", [("conv2d", 80), ("linear", 512)])
def test_avsr_embedding(input_layer, idim):
    from tailored_avsr_tpu.models.embedding import DefaultEmbeddingLayerForAVSR as J
    from tailored_avsr_tpu_torch.models.embedding import DefaultEmbeddingLayerForAVSR as P

    x = np.random.RandomState(9).randn(2, 17, idim).astype(np.float32)
    lens = np.array([17, 12], np.int32)
    jm = J(32, input_layer, dropout_rate=0.0, positional_dropout_rate=0.0)
    v = jax_module(jm, x, lens)
    root = "acoustic_embed" if input_layer == "conv2d" else "visual_embed"
    pm = load_port(P(idim, 32, input_layer, dropout_rate=0.0, positional_dropout_rate=0.0), v, root)
    want_x, want_lens, want_pos = jm.apply(v, x, lens)
    with torch.no_grad():
        got_x, got_lens = pm.apply_embed_layer(t(x), t(lens))
        got_x, got_pos = pm.apply_pos_enc(got_x)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got_x, want_x, atol=2e-5)  # x * sqrt(d) scales the rounding
    close(got_pos, want_pos)


def test_tailored_layer_unstacked_streams():
    """Streams of different lengths take the per-modality FFN path (equal
    shapes take the stacked one, covered by the slice tests)."""
    from tailored_avsr_tpu.models.tailored import TailoredEncoderLayer as J
    from tailored_avsr_tpu.ops.posenc import rel_pos_table
    from tailored_avsr_tpu_torch.models.tailored import TailoredEncoderLayer as P

    rs = np.random.RandomState(10)
    a = rs.randn(2, 9, 32).astype(np.float32)
    vv = rs.randn(2, 6, 32).astype(np.float32)
    apos, vpos = rel_pos_table(9, 32)[None], rel_pos_table(6, 32)[None]
    am = np.arange(9)[None] < np.array([9, 7])[:, None]
    vm = np.arange(6)[None] < np.array([6, 4])[:, None]
    kw = dict(attention_heads=4, cgmlp_linear_units=24, cgmlp_conv_kernel=3, linear_units=40)
    jm = J(32, acoustic_use_attn=False, visual_use_attn=True, dropout_rate=0.0, **kw)
    v = jax_module(jm, a, apos, am, vv, vpos, vm)
    pm = load_port(P(32, False, True, dropout_rate=0.0, **kw), v, "encoder")
    want_a, want_v = jm.apply(v, a, apos, am, vv, vpos, vm)
    with torch.no_grad():
        got_a, got_v = pm(t(a), t(apos), t(am), t(vv), t(vpos), t(vm))
    close(got_a, want_a)
    close(got_v, want_v)


@pytest.mark.parametrize("merge", ["concat", "learned_ave", "fixed_ave"])
def test_adaptive_fusion(merge):
    from tailored_avsr_tpu.models.fusion import AdaptiveAudioVisualFusion as J
    from tailored_avsr_tpu_torch.models.fusion import AdaptiveAudioVisualFusion as P

    rs = np.random.RandomState(11)
    a = rs.randn(2, 7, 16).astype(np.float32)
    vv = rs.randn(2, 7, 16).astype(np.float32)
    am = np.arange(7)[None] < np.array([7, 3])[:, None]
    vm = np.arange(7)[None] < np.array([5, 6])[:, None]
    jm = J(16, 24, merge_method=merge, acoustic_weight=0.3)
    v = jax_module(jm, a, am, vv, vm)
    pm = load_port(P(16, 24, merge_method=merge, acoustic_weight=0.3), v, "audiovisual_fusion")
    want, want_mask, want_aux = jm.apply(v, a, am, vv, vm)
    with torch.no_grad():
        got, got_mask, got_aux = pm(t(a), t(am), t(vv), t(vm))
    close(got, want)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert sorted(got_aux) == sorted(want_aux)
    for k in want_aux:
        close(got_aux[k], want_aux[k])


def test_ctc_head():
    from tailored_avsr_tpu.models.ctc import CTCHead as J
    from tailored_avsr_tpu_torch.models.ctc import CTCHead as P

    x = np.random.RandomState(12).randn(2, 5, 16).astype(np.float32)
    jm = J(vocab_size=11)
    v = jax_module(jm, x)
    pm = load_port(P(16, 11), v, "ctc")
    with torch.no_grad():
        close(pm.log_softmax(t(x)), jm.apply(v, x, method=jm.log_softmax))
        np.testing.assert_array_equal(
            pm.argmax(t(x)).numpy(), np.asarray(jm.apply(v, x, method=jm.argmax)))


def test_ctc_greedy_collapse():
    from tailored_avsr_tpu.decode.greedy import ctc_greedy_collapse as J
    from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse as P

    ids = np.random.RandomState(13).randint(0, 4, (4, 20))
    lens = np.array([20, 11, 1, 0])
    assert P(ids, lens) == J(ids, lens)


@pytest.mark.parametrize("name,section,value", [
    # the Conformer stacks, zero_triu and the Sim-T decoder these cases
    # refused are built by
    # tests/test_torch_port_asr.py::test_ported_choices_build_with_the_jax_parameter_names;
    # the multi-speaker encoder, the last two refused, is an ASR encoder,
    # which the AVSR task rejects as the JAX task does, and the linear
    # pre-encoder builds
    ("conventional_transformer+ctc_spanish.yaml", "encoder", "transformer_multispkr"),
    ("tailored_transformer+ctc_spanish.yaml", "acoustic_preencoder", "linear"),
])
def test_build_model_names_roadmap_item_for_unported_choices(name, section, value):
    """Each AVSR choice the port refused naming item 8 now does what the JAX
    task does: the multi-speaker encoder raises the JAX task's ValueError
    in both packages, and the flagship with a linear acoustic pre-encoder
    (80 -> 64 features) builds at full width with the JAX parameter names
    and shapes."""
    from tailored_avsr_tpu.utils.config import load_config
    from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
    from tailored_avsr_tpu_torch.tasks.avsr import build_meta
    from test_torch_port_asr import _jax_model, _jax_shapes

    cfg = load_config(os.path.join(ROOT, "configs/AVSR", name))
    setattr(cfg, section, value)
    setattr(cfg, f"{section}_conf", {"output_size": 64})
    tokens = ["<blank>", "a", "<sos/eos>"]
    if section == "encoder":
        for build in (lambda: build_meta(cfg, list(tokens)), lambda: _jax_model(cfg, list(tokens))):
            with pytest.raises(ValueError, match="unknown AVSR encoder: transformer_multispkr"):
                build()
        return
    port = build_meta(cfg, list(tokens))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
                                   _jax_shapes(_jax_model(cfg, list(tokens)), "avsr"))
    want = {k: v.shape for k, v in export_torch_state_dict(zeros).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got == want and port.acoustic_preencoder.linear_out.weight.shape == (64, 80)


def test_port_imports_no_jax():
    """The port, every module of it, imports no JAX, flax, optax or pandas
    (the card's machine has no pandas), directly or transitively."""
    pkg = os.path.join(ROOT, "tailored_avsr_tpu_torch")
    mods = sorted(
        "tailored_avsr_tpu_torch." + os.path.relpath(os.path.join(d, f), pkg)[:-3].replace(os.sep, ".")
        for d, _, files in os.walk(pkg) for f in files
        if f.endswith(".py") and f != "__init__.py"
    )
    beam_slice = {f"tailored_avsr_tpu_torch.{m}" for m in (
        "inference", "ops.group_attend", "ops.cache_update", "models.decoder", "models.lm",
        "decode.ctc_prefix", "decode.beam_search", "tasks.lm")}
    train_slice = {f"tailored_avsr_tpu_torch.{m}" for m in (
        "avsr_main", "ops.losses", "ops.specaug", "train.optim", "train.loop", "train.checkpoint",
        "data.tokenizer", "data.transforms_audio", "data.transforms_video", "data.dataset",
        "data.dataloader", "evaluation.wer")}
    branchformer_slice = {f"tailored_avsr_tpu_torch.{m}" for m in (
        "models.branchformer", "models.conventional", "models.asr_model", "tasks.common", "tasks.asr",
        "study_branches")}
    assert beam_slice <= set(mods) and train_slice <= set(mods) and branchformer_slice <= set(mods)
    assert len(mods) > 46
    forbidden = ("jax", "flax", "optax", "pandas")
    code = (
        "import sys, importlib, tailored_avsr_tpu_torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {forbidden!r}]\n"
        "assert not bad, bad[:5]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["tailored_transformer+ctc_spanish.yaml",
                                  "tailored_transformer+ctc_spanish_tpu.yaml"])
def test_load_config_matches_jax(name):
    from tailored_avsr_tpu.utils.config import load_config as jload
    from tailored_avsr_tpu_torch.utils.config import load_config

    path = os.path.join(ROOT, "configs/AVSR", name)
    assert vars(load_config(path)) == vars(jload(path))
