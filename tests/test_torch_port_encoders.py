"""The encoders on the Branchformer base (Conformer, E-Branchformer,
Transformer, Longformer), their attention and position variants, interCTC
and the ``word`` / none token types, the port against the JAX package in
f32 on the CPU.

- Modules: the scaled-absolute and legacy rel-pos encodings, the legacy
  shift and ``zero_triu`` in the rel-pos attention (eager, and K2's plain
  version on the bias they build; K1 never reached), Fastformer's
  attention, the absolute MHA under a (B, T) key mask and a Longformer
  band, ``Conv1dSubsampling`` and its lengths, the Conformer conv module in
  train mode (BatchNorm running statistics against JAX's ``batch_stats``).
- Layers: Branchformer (E-Branchformer merge, ``selfattn``,
  ``fast_selfattn``, legacy, ``zero_triu``), Conformer (eval, and train
  mode under stochastic depth: all four residuals scaled) and Transformer
  (with a window).
- Encoders through both registries (every new name, input layer and
  position type, taps), the conventional Conformer stacks, the tailored
  encoder's attention variants and ``normalize_before: false``.
- Models: interCTC loss and gradients (ASR Conformer with conditioning, at
  ``ctc_weight`` 0.3 and 0.0; the tailored AVSR model with audio-visual
  conditioning), a Conformer's BatchNorm moved once under ``remat``, the
  ``init`` schemes over a Conformer, ``Speech2Text`` greedy and nbest on a
  Conformer ASR, and the ``word`` / none token types.

Sizes: 32-d, 4 heads, 2 blocks, kernels 5-7 (the models: the tiny
Branchformer family's 64-d configs). Weights come from the JAX side
(perturbed or ``_random_variables``) through the key-grammar export and a
strict load. Tolerances: module and layer outputs 1e-5 (the layers 1e-4),
BatchNorm statistics 1e-6; encoder outputs 1e-4 on valid frames and 2e-3
on padded ones (flax's one-pass LayerNorm variance, ``ROADMAP.md`` §3, PR
1's note); greedy ids identical; nbest scores 1e-4; losses and gradients
as ``tests/test_torch_port_branchformer.py`` holds them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
from test_torch_port_branchformer import ASR, CONVENTIONAL, TOKEN_LIST, _load, speech_batch, tiny_cfg
from test_torch_port_ops import jax_module, load_port, perturb
from test_torch_port_slice import _random_variables

D, H = 32, 4
SMALL = dict(output_size=D, attention_heads=H, linear_units=48, cgmlp_linear_units=48, cgmlp_conv_kernel=7,
             num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.asarray(x))


def _mask(lengths, t_max):
    return np.arange(t_max)[None] < np.asarray(lengths)[:, None]


def _close_frames(got, want, valid, atol=1e-4, pad_atol=2e-3):
    """Valid frames within ``atol``, padded ones within ``pad_atol``, all finite."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=atol)
    np.testing.assert_allclose(got[~valid], want[~valid], atol=pad_atol)


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("kind", ["abs_pos", "scaled_abs_pos", "legacy_rel_pos"])
def test_positional_encodings_match_jax(kind):
    """x * sqrt(d) + PE; x + alpha * PE with a learned alpha (perturbed off
    1); the legacy (1, T, D) table beside x * sqrt(d)."""
    from tailored_avsr_tpu.ops import posenc as J
    from tailored_avsr_tpu_torch.ops import posenc as P

    x = np.random.RandomState(1).randn(2, 9, D).astype(np.float32)
    jm = {"abs_pos": J.AbsolutePositionalEncoding, "scaled_abs_pos": J.ScaledPositionalEncoding,
          "legacy_rel_pos": J.LegacyRelPositionalEncoding}[kind](0.0)
    variables = jax_module(jm, x)
    want = jm.apply(variables, x)
    pm = P.positional_encoding(kind, 0.0)
    if variables:
        load_port(pm, variables, "pos_enc")
        assert float(pm.alpha.detach()) != 1.0
    with torch.no_grad():
        got = pm.eval()(t(x))
    for g, w in zip(got if kind in P.RELATIVE else [got], want if kind in P.RELATIVE else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("legacy,zero_triu", [(True, False), (False, True), (True, True)],
                         ids=["legacy", "zero_triu", "legacy_zero_triu"])
def test_rel_attention_variants_match_jax_and_never_reach_k1(legacy, zero_triu, monkeypatch):
    """The legacy shift and ``zero_triu`` against the JAX plain path, eager
    and through K2's plain version (``use_flash``, eval: the bias they build
    streamed as K2 streams it), one utterance fully masked. With the K1
    switch at 0 bytes they still take K2; the "latest" shift takes K1."""
    from tailored_avsr_tpu.ops.attention import RelPositionMultiHeadedAttention as J
    from tailored_avsr_tpu.ops.attention import legacy_rel_shift as jshift
    from tailored_avsr_tpu_torch.ops import attention as pa
    from tailored_avsr_tpu_torch.ops import flash_attention as fa

    rs = np.random.RandomState(2)
    x = rs.randn(3, 9, D).astype(np.float32)
    pos = rs.randn(1, 9 if legacy else 17, D).astype(np.float32)
    mask = _mask([9, 4, 0], 9)
    scores = rs.randn(2, H, 9, 9).astype(np.float32)
    np.testing.assert_array_equal(pa.legacy_rel_shift(t(scores)).numpy(), np.asarray(jshift(scores)))
    jm = J(H, 0.0, zero_triu, False, legacy=legacy)
    variables = jax_module(jm, x, x, x, pos, mask)
    want = np.asarray(jm.apply(variables, x, x, x, pos, mask))
    pm = load_port(pa.RelPositionMultiHeadedAttention(D, H, 0.0, False, zero_triu, legacy), variables, "attn")
    calls = []
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append("K2") or fa.flash_attention_plain(
        *a, **k))
    monkeypatch.setattr(fa, "flash_attention_relpos", lambda *a, **k: calls.append("K1") or
                        fa.flash_attention_relpos_plain(*a, **k))
    monkeypatch.setattr(pa, "FLASH_RELPOS_MIN_BIAS_BYTES", 0)
    with torch.no_grad():
        eager = pm(t(x), t(x), t(x), t(pos), t(mask))
        pm.use_flash = True
        k2 = pm(t(x), t(x), t(x), t(pos), t(mask))
    assert calls == ["K2"]
    for got in (eager, k2):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    latest = pa.RelPositionMultiHeadedAttention(D, H, 0.0, True).eval()
    latest.load_state_dict(pm.state_dict())
    with torch.no_grad():
        latest(t(x), t(x), t(x), t(rs.randn(1, 17, D).astype(np.float32)), t(mask))
    assert calls == ["K2", "K1"]


def test_fast_self_attention_matches_jax():
    """Fastformer: f32 pooling softmax with MASK_MIN, masked weights zeroed
    (a fully masked utterance pools to 0), ``out + query``."""
    from tailored_avsr_tpu.ops.attention import FastSelfAttention as J
    from tailored_avsr_tpu_torch.ops.attention import FastSelfAttention as P

    x = np.random.RandomState(3).randn(3, 8, D).astype(np.float32)
    mask = _mask([8, 5, 0], 8)
    jm = J(H, 0.0)
    variables = jax_module(jm, x, mask)
    pm = load_port(P(D, H), variables, "attn")
    with torch.no_grad():
        for m in (mask, None):
            got = pm(t(x), None if m is None else t(m))
            assert torch.isfinite(got).all()
            np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, x, m)), atol=1e-5)


@pytest.mark.parametrize("window", [0, 4], ids=["key_mask", "longformer_band"])
def test_absolute_mha_as_encoder_self_attention_matches_jax(window):
    """The decoder's MHA as an encoder self-attention: a (B, T) key mask, or
    that mask intersected with a band (B, T, T); a fully padded utterance
    gives what JAX gives (zeros before ``linear_out``)."""
    from tailored_avsr_tpu.models.transformer_encoder import TransformerEncoderLayer as JL
    from tailored_avsr_tpu.ops.attention import MultiHeadedAttention as J
    from tailored_avsr_tpu_torch.models.transformer_encoder import window_mask
    from tailored_avsr_tpu_torch.ops.attention import MultiHeadedAttention as P

    x = np.random.RandomState(4).randn(3, 10, D).astype(np.float32)
    mask = _mask([10, 6, 0], 10)
    band = window_mask(t(mask), 10, window)
    want_band = JL(D, attention_window=window)._window_mask(jnp.asarray(mask), 10)
    np.testing.assert_array_equal(band.numpy(), np.asarray(want_band))
    jm = J(H, 0.0, D)
    variables = jax_module(jm, x, x, x, np.asarray(want_band))
    pm = load_port(P(H, 0.0, D), variables, "self_attn")
    with torch.no_grad():
        got = pm(t(x), t(x), t(x), band)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, x, x, x, np.asarray(want_band))),
                               atol=1e-5)


@pytest.mark.parametrize("factor", [2, 3])
def test_conv1d_subsampling_matches_jax(factor):
    """One VALID conv over time and a ReLU; the lengths by the conv1d rule."""
    from tailored_avsr_tpu.ops.subsampling import Conv1dSubsampling as J
    from tailored_avsr_tpu.ops.subsampling import subsampled_length as jlen
    from tailored_avsr_tpu_torch.ops.subsampling import Conv1dSubsampling as P
    from tailored_avsr_tpu_torch.ops.subsampling import subsampled_length as plen

    x = np.random.RandomState(5).randn(2, 23, 20).astype(np.float32)
    jm = J(D, factor)
    variables = jax_module(jm, x)
    pm = _load(P(20, D, factor), {c: {"embed_conv": v} for c, v in variables.items()}, "embed.")
    with torch.no_grad():
        np.testing.assert_allclose(pm(t(x)).numpy(), np.asarray(jm.apply(variables, x)), atol=1e-5)
    lens = np.arange(0, 30)
    np.testing.assert_array_equal(plen(t(lens), factor, conv1d=True).numpy(), np.asarray(jlen(lens, factor, True)))


def test_conformer_conv_module_train_mode_moves_batch_stats_as_jax():
    """Train mode: the batch statistics over every (B, T) position, padded
    frames included; the output within 1e-5 and the running mean and the
    (biased) running variance within 1e-6 of JAX's ``batch_stats``. Eval
    mode: the running statistics, within 1e-5."""
    from tailored_avsr_tpu.models.conformer import ConformerConvModule as J
    from tailored_avsr_tpu_torch.models.conformer import ConformerConvModule as P

    x = np.random.RandomState(6).randn(3, 11, D).astype(np.float32)
    jm = J(kernel_size=5)
    variables = jax_module(jm, x)
    pm = load_port(P(D, 5), variables, "conv_module").train()
    want, moved = jm.apply(variables, x, deterministic=False, mutable=["batch_stats"])
    with torch.no_grad():
        got = pm(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    stats = moved["batch_stats"]["norm"]
    np.testing.assert_allclose(pm.norm.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(pm.norm.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    assert not np.allclose(np.asarray(stats["var"]), variables["batch_stats"]["norm"]["var"])
    with torch.no_grad():
        np.testing.assert_allclose(pm.eval()(t(x)).numpy(), np.asarray(jm.apply(dict(variables, **moved), x)),
                                   atol=1e-5)


# ---------------------------------------------------------------- layers

LAYER_CASES = {
    # name: (JAX layer class name, layer keywords, positional table)
    "e_branchformer": ("branchformer", dict(merge_method="concat", merge_conv_kernel=3), "rel"),
    "selfattn": ("branchformer", dict(attention_layer_type="selfattn"), None),
    "fast_selfattn": ("branchformer", dict(attention_layer_type="fast_selfattn"), None),
    "legacy_zero_triu": ("branchformer", dict(attention_layer_type="legacy_rel_selfattn", zero_triu=True), "legacy"),
    "conformer": ("conformer", dict(cnn_module_kernel=5), "rel"),
    "conformer_legacy": ("conformer", dict(cnn_module_kernel=5, attention_layer_type="legacy_rel_selfattn"),
                         "legacy"),
    "conformer_selfattn": ("conformer", dict(cnn_module_kernel=5, attention_layer_type="selfattn"), None),
    "transformer_window": ("transformer", dict(attention_window=4), None),
}


def _layer_pair(kind, kw):
    from tailored_avsr_tpu.models.branchformer import BranchformerEncoderLayer as JB
    from tailored_avsr_tpu.models.conformer import ConformerEncoderLayer as JC
    from tailored_avsr_tpu.models.transformer_encoder import TransformerEncoderLayer as JT
    from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoderLayer as PB
    from tailored_avsr_tpu_torch.models.conformer import ConformerEncoderLayer as PC
    from tailored_avsr_tpu_torch.models.transformer_encoder import TransformerEncoderLayer as PT

    common = dict(attention_heads=H, linear_units=48, dropout_rate=0.0)
    if kind == "branchformer":
        common.update(cgmlp_linear_units=48, cgmlp_conv_kernel=7)
    cls = {"branchformer": (JB, PB), "conformer": (JC, PC), "transformer": (JT, PT)}[kind]
    return cls[0](size=D, name="layer_0", **common, **kw), cls[1](D, **common, **kw)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_new_layers_match_jax(case):
    """Each new layer kind in eval, an empty utterance among the lengths:
    within 1e-4 on valid frames, finite everywhere, a strict load; the
    learned merge's weights within 1e-5."""
    kind, kw, table = LAYER_CASES[case]
    rs = np.random.RandomState(len(case))
    b, tt = 3, 9
    x = rs.randn(b, tt, D).astype(np.float32)
    pos = None if table is None else rs.randn(1, tt if table == "legacy" else 2 * tt - 1, D).astype(np.float32)
    mask = _mask([9, 5, 0], tt)
    jl, pl = _layer_pair(kind, kw)
    variables = perturb(jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(0), x, pos, mask)))
    want, want_aux = jl.apply(variables, x, pos, mask)
    pl = _load(pl, {c: {"layer_0": v} for c, v in variables.items()}, "encoders.0.")
    with torch.no_grad():
        got, aux = pl(t(x), None if pos is None else t(pos), t(mask))
    assert torch.isfinite(got).all() and set(aux) == set(want_aux)
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], atol=1e-4)
    for key in aux:  # the learned merge's branch weights
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(want_aux[key]), atol=1e-5)


@pytest.mark.parametrize("kind", ["conformer", "transformer"])
def test_stochastic_depth_scales_every_residual_as_jax(kind):
    """Train mode, rate 0.4, a kept layer (the JAX ``skip`` coin read off its
    output; the port's coins passed in): every residual scaled by 1 / 0.6
    (the Conformer's four, its BatchNorm on batch statistics), within 1e-4."""
    kw = dict(cnn_module_kernel=5) if kind == "conformer" else {}
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, D).astype(np.float32)
    pos = rs.randn(1, 17, D).astype(np.float32)
    mask = _mask([9, 6], 9)
    jl, pl = _layer_pair(kind, dict(kw, stochastic_depth_rate=0.4))
    variables = perturb(jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(0), x, pos, mask)))
    for seed in range(20):
        want, _ = jl.apply(variables, x, pos, mask, deterministic=False, mutable=["batch_stats"],
                           rngs={"skip": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(0)})[0]
        if not np.allclose(np.asarray(want), x):
            break
    pl = _load(pl, {c: {"layer_0": v} for c, v in variables.items()}, "encoders.0.").train()
    with torch.no_grad():
        got, _ = pl(t(x), t(pos), t(mask), coins=(False, False))
        base, _ = _load(_layer_pair(kind, kw)[1], {c: {"layer_0": v} for c, v in variables.items()},
                        "encoders.0.").train()(t(x), t(pos), t(mask), coins=(False, False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert not torch.allclose(got, base, atol=1e-3)


# ---------------------------------------------------------------- encoders

ENCODER_CASES = {
    # registry name, encoder keys, input layer feature width, lengths
    "conformer": ("conformer", dict(cnn_module_kernel=5, interctc_layer_idx=[1]), (41, 30, 0)),
    "conformer_legacy": ("conformer", dict(cnn_module_kernel=5, rel_pos_type="legacy"), (41, 22)),
    "conformer_selfattn_scaled": ("conformer", dict(cnn_module_kernel=5, attention_layer_type="selfattn",
                                                    pos_enc_layer_type="scaled_abs_pos"), (37, 26)),
    "e_branchformer_zero_triu": ("e_branchformer", dict(zero_triu=True), (41, 30)),
    "e_branchformer_conv1d2": ("e_branchformer", dict(input_layer="conv1d2"), (19, 12)),
    "branchformer_conv1d3_fast": ("branchformer", dict(input_layer="conv1d3", attention_layer_type="fast_selfattn",
                                                       pos_enc_layer_type="abs_pos"), (23, 15)),
    "branchformer_embed_no_after_norm": ("branchformer", dict(input_layer="embed", input_size=40,
                                                              attention_layer_type="selfattn",
                                                              pos_enc_layer_type="abs_pos", normalize_before=False,
                                                              interctc_layer_idx=[1, 2]), (9, 5, 0)),
    "transformer": ("transformer", {}, (41, 30)),
    "transformer_rel": ("transformer", dict(attention_layer_type="rel_selfattn", pos_enc_layer_type="rel_pos"),
                        (41, 30)),
    "longformer": ("longformer", dict(attention_windows=4), (41, 30)),
    "longformer_per_layer": ("longformer", dict(attention_windows=[2, 6], interctc_layer_idx=[1]), (45, 19)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_registry_encoders_match_jax(case):
    """Each encoder name of the registry, built by both packages' registries
    from the same keys (the transformer and longformer defaults: abs_pos,
    selfattn, ReLU): lengths equal, outputs and interCTC taps within 1e-4
    on valid frames and 2e-3 on padded ones, branch weights within 1e-5."""
    from tailored_avsr_tpu.tasks.common import build_encoder as jbuild
    from tailored_avsr_tpu_torch.tasks.common import build_encoder, materialize

    name, kw, lengths = ENCODER_CASES[case]
    conf = dict(SMALL, **kw)
    rs = np.random.RandomState(len(case))
    if conf.get("input_layer") == "embed":
        x = rs.randint(0, 40, (len(lengths), max(lengths))).astype(np.int32)
    else:
        x = rs.randn(len(lengths), max(lengths), 20).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    je = jbuild(name, dict(conf), vocab_size=11)
    variables = perturb(jax.tree_util.tree_map(np.asarray, je.init(jax.random.PRNGKey(0), x, lens)))
    want, want_lens, want_aux = jax.jit(lambda v, a, b: je.apply(v, a, b))(variables, x, lens)
    pe = materialize(build_encoder(name, dict(conf), input_size=20, vocab_size=11), None, "cpu", None)
    assert type(pe).__name__ == type(je).__name__
    _load(pe, {c: {"encoder": v} for c, v in variables.items()}, "encoder.")
    with torch.no_grad():
        got, got_lens, aux = pe(t(x), t(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    valid = _mask(np.asarray(want_lens), got.shape[1])
    _close_frames(got.numpy(), want, valid)
    taps = aux["intermediate_outs"]
    assert [i for i, _ in taps] == [i for i, _ in want_aux["intermediate_outs"]] == list(kw.get(
        "interctc_layer_idx", []))
    for (_, g), (_, w) in zip(taps, want_aux["intermediate_outs"]):
        _close_frames(g.numpy(), w, valid)
    assert [i for i, _ in aux["branch_weights"]] == [i for i, _ in want_aux["branch_weights"]]


@pytest.fixture(scope="module")
def conventional_conformer():
    """The tiny conventional AVSR model with Conformer stacks (kernel 5), its
    JAX variables (BatchNorm statistics random) and the port on them."""
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
    from test_torch_port_branchformer import _av_batch

    cfg = tiny_cfg(CONVENTIONAL, encoder_class_type="conformer", cnn_module_kernel=5, interctc_layer_idx=[1],
                   interctc_use_conditioning=True, audiovisual_interctc_conditioning=True)
    jm = AVSRTask.build_model(cfg, list(TOKEN_LIST))
    args = _av_batch(9, 10)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *args, np.ones((2, 4), np.int32), np.full((2,), 4, np.int32)))
    variables = _random_variables(shapes, seed=8)
    pm = build_model(cfg, TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    return cfg, jm, variables, pm, args


def test_conventional_conformer_stacks_match_jax(conventional_conformer):
    """Two Conformer stacks, a tap after layer 1 fused and fed back through
    the audio-visual conditioning: encoder output within 1e-4 on valid
    frames, the tap within 1e-4, greedy ids equal."""
    cfg, jm, variables, pm, args = conventional_conformer

    @jax.jit
    def serve(v, *a):
        enc, lens, aux = jm.apply(v, *a, method="encode")
        return enc, lens, jm.apply(v, enc, method=lambda m, x: m.ctc.argmax(x)), aux["intermediate_outs"]

    enc, lens, ids, taps = jax.device_get(serve(variables, *args))
    with torch.no_grad():
        got, got_lens, aux = pm.encode(*(t(a) for a in args))
        got_ids, _ = pm.ctc_greedy(*(t(a) for a in args))
    np.testing.assert_array_equal(got_lens.numpy(), lens)
    valid = _mask(lens, got.shape[1])
    np.testing.assert_allclose(got.numpy()[valid], enc[valid], atol=1e-4)
    np.testing.assert_array_equal(got_ids.numpy()[valid], ids[valid])
    assert [i for i, _ in aux["intermediate_outs"]] == [i for i, _ in taps] == [1]
    np.testing.assert_allclose(aux["intermediate_outs"][0][1].numpy()[valid], taps[0][1][valid], atol=1e-4)
    assert aux["branch_weights"] == []


TAILORED_CASES = {
    "selfattn": dict(attention_layer_type="selfattn"),
    "fast_selfattn": dict(attention_layer_type="fast_selfattn"),
    "legacy": dict(attention_layer_type="legacy_rel_selfattn"),
    "zero_triu": dict(zero_triu=True),
    "no_normalize_before": dict(normalize_before=False),
}


@pytest.mark.parametrize("case", sorted(TAILORED_CASES))
def test_tailored_variants_match_jax(case):
    """The tailored encoder with each attention variant (the table its type
    pairs with) and without ``after_norm``: both streams within 1e-4 on
    valid frames, the stacked-FFN path (equal shapes)."""
    from tailored_avsr_tpu.models.tailored import TailoredEncoder as J
    from tailored_avsr_tpu_torch.models.tailored import TailoredEncoder as P

    kw = TAILORED_CASES[case]
    att = kw.get("attention_layer_type", "rel_selfattn")
    conf = dict(SMALL, acoustic_use_attn=(True, False), visual_use_attn=(True, True), **kw)
    del conf["positional_dropout_rate"]
    rs = np.random.RandomState(len(case))
    a, v = (rs.randn(2, 9, D).astype(np.float32) for _ in range(2))
    rows = {"rel_selfattn": 17, "legacy_rel_selfattn": 9}.get(att)
    pos = None if rows is None else rs.randn(1, rows, D).astype(np.float32)
    am, vm = _mask([9, 6], 9), _mask([9, 5], 9)
    je = J(**conf)
    variables = perturb(jax.tree_util.tree_map(np.asarray, je.init(jax.random.PRNGKey(0), a, pos, am, v, pos, vm)))
    want = je.apply(variables, a, pos, am, v, pos, vm)
    pe = _load(P(**conf), {c: {"encoder": x} for c, x in variables.items()}, "encoder.")
    assert (pe.after_norm is None) == (case == "no_normalize_before")
    p = None if pos is None else t(pos)
    with torch.no_grad():
        got = pe(t(a), p, t(am), t(v), p, t(vm))
    for g, w, m in ((got[0], want[0], am), (got[2], want[2], vm)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m], atol=1e-4)


# ---------------------------------------------------------------- interCTC loss and gradients


def _asr_models(seed=0, model_conf=None, **encoder):
    """(cfg, JAX model, variables, port model) of the tiny ASR config with a
    Conformer encoder (kernel 5)."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu_torch.tasks.asr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    cfg = tiny_cfg(ASR, cnn_module_kernel=5, **encoder)
    cfg.encoder = "conformer"
    cfg.model_conf = dict(cfg.model_conf, **(model_conf or {}))
    jm = ASRTask.build_model(cfg, list(TOKEN_LIST))
    b = speech_batch("asr")
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, b["speech"], b["speech_lengths"],
                                            b["text"], b["text_lengths"]))
    variables = _random_variables(shapes, seed=seed)
    pm = build_model(cfg, TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(variables, pm)
    assert dropped == []
    pm.load_state_dict(sd, strict=True)
    return cfg, jm, variables, pm


def _loss_and_grads_match(jm, variables, pm, args, keys):
    """The JAX loss and gradients (deterministic, jitted) against the port's
    (eval mode): the loss and ``keys`` within 1e-5 relative, each gradient
    within 1e-4 of its tensor's largest JAX entry plus 1e-5 of the model's
    largest."""
    @jax.jit
    def run(params, state):
        return jax.value_and_grad(lambda p: jm.apply({"params": p, **state}, *args), has_aux=True)(params)

    state = {k: v for k, v in variables.items() if k != "params"}
    (want_loss, want_stats), want_grads = jax.device_get(run(variables["params"], state))
    pm.eval()
    loss, stats = pm(*(t(a) for a in args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in keys:
        np.testing.assert_allclose(float(stats[key].detach()), float(want_stats[key]), rtol=1e-5, err_msg=key)
    want = {k: np.asarray(v) for k, v in export_torch_state_dict({"params": want_grads}).items()}
    named = dict(pm.named_parameters())
    assert set(want) == set(named)
    floor = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for name, p in named.items():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=floor + 1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
    return stats


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
def test_asr_interctc_loss_and_gradients_match_jax(ctc_weight):
    """A Conformer ASR model with taps after layers 1 and 2, conditioned on
    the CTC head's posteriors, ``interctc_weight`` 0.4: the loss (at
    ``ctc_weight`` 0 the interCTC term alone, mixed with the attention loss
    by its weight), each tap's CTC loss and every gradient, the
    conditioning layer's among them."""
    cfg, jm, variables, pm = _asr_models(
        seed=9, model_conf=dict(ctc_weight=ctc_weight, interctc_weight=0.4), interctc_layer_idx=[1, 2],
        interctc_use_conditioning=True)
    b = speech_batch("asr")
    args = tuple(b[k] for k in ("speech", "speech_lengths", "text", "text_lengths"))
    keys = ["loss_interctc_layer1", "loss_interctc_layer2", "loss_att"] + (["loss_ctc"] if ctc_weight else [])
    stats = _loss_and_grads_match(jm, variables, pm, args, keys)
    assert pm.encoder.conditioning_layer.weight.grad.abs().max() > 0
    assert ("loss_ctc" in stats) == bool(ctc_weight)


def test_avsr_interctc_audiovisual_conditioning_loss_and_gradients_match_jax():
    """The tiny tailored AVSR model, a tap after layer 1 fused by the fusion
    module and fed back through ``ctc.softmax`` of the fused tap to both
    streams, ``interctc_weight`` 0.3: loss, the tap's CTC loss and every
    gradient."""
    import __graft_entry__ as graft
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
    from test_torch_port_branchformer import _av_batch

    cfg = graft._flagship_cfg(tiny=True)
    cfg.token_list = tiny_cfg(ASR).token_list
    cfg.specaug = None
    cfg.encoder_conf = dict(cfg.encoder_conf, dropout_rate=0.0, attention_dropout_rate=0.0,
                            interctc_layer_idx=[1], interctc_use_conditioning=True,
                            audiovisual_interctc_conditioning=True)
    cfg.model_conf = dict(cfg.model_conf, interctc_weight=0.3)
    for key in ("decoder_conf", "audiovisual_fusion_conf", "acoustic_embed_conf", "visual_embed_conf"):
        setattr(cfg, key, {k: (0.0 if "dropout" in k else v) for k, v in getattr(cfg, key).items()})
    jm = AVSRTask.build_model(cfg, list(TOKEN_LIST))
    av = _av_batch(5, 6)
    text = np.array([[4, 9, 12, 5], [7, 3, 8, -1]], np.int32)
    args = (*av, text, np.array([4, 3], np.int32))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)}, *args))
    variables = _random_variables(shapes, seed=10)
    pm = build_model(cfg, TOKEN_LIST, device="cpu")
    pm.load_state_dict(convert_jax_variables(variables, pm)[0], strict=True)
    _loss_and_grads_match(jm, variables, pm, args, ["loss_interctc_layer1", "loss_ctc", "loss_att"])
    assert pm.encoder.conditioning_layer.weight.grad.abs().max() > 0


def test_conformer_batch_stats_move_once_under_remat():
    """A Conformer ASR model's train forward and backward under ``remat``:
    the loss and every gradient those of the plain step, and the conv
    modules' running statistics moved once (equal to the plain step's, not
    to the start's)."""
    from tailored_avsr_tpu_torch.models import remat

    _, _, _, pm = _asr_models(seed=12)
    b = speech_batch("asr")
    args = tuple(t(b[k]) for k in ("speech", "speech_lengths", "text", "text_lengths"))
    start = copy.deepcopy(pm.state_dict())
    runs = []
    for on in (False, True):
        pm.load_state_dict(start)
        pm.zero_grad()
        pm.train()
        with remat.enabled(on):
            loss, _ = pm(*args)
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad.clone() for n, p in pm.named_parameters()},
                     {k: v.clone() for k, v in pm.state_dict().items() if "running" in k}))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == pytest.approx(l1, rel=1e-6) and len(s0) == 4  # two conv modules' mean and var
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-6)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=1e-7)
        assert not torch.allclose(s1[k], start[k])


@pytest.mark.parametrize("scheme", ["xavier_uniform", "kaiming_normal"])
def test_init_schemes_over_a_conformer_match_jax(scheme):
    """The JAX ``initialize`` and the port's over a Conformer ASR model: each
    leaf in the same class (kept, zeros, ones, redrawn: the conv module's
    depthwise and pointwise kernels redrawn, its BatchNorm statistics
    kept); the redrawn leaves of >= 4096 entries at the scheme's std
    within 10 %."""
    from tailored_avsr_tpu.utils.initialize import initialize as jinit
    from tailored_avsr_tpu_torch.utils.initialize import initialize
    from test_torch_port_recipe import _leaf_class, _scheme_std_tree

    _, _, variables, pm = _asr_models(seed=13)
    before = export_torch_state_dict(variables)
    after_j = export_torch_state_dict(jax.device_get(jinit(variables, scheme)))
    initialize(pm, scheme, torch.Generator().manual_seed(0))
    after_p = {k: v.numpy() for k, v in pm.state_dict().items()}
    std = export_torch_state_dict({"params": _scheme_std_tree(variables["params"], scheme)})
    checked = 0
    for k in before:
        cj = _leaf_class(before[k], after_j[k])
        assert cj == _leaf_class(before[k], after_p[k]), k
        if "conv_module.depthwise_conv.weight" in k or "conv_module.pointwise_conv1.weight" in k:
            assert cj == "redrawn", k
        if "running" in k:
            assert cj == "kept", k
        if cj == "redrawn" and before[k].size >= 4096:
            for got in (after_j[k].std(), after_p[k].std()):
                assert abs(got / float(std[k].flat[0]) - 1) <= 0.1, (k, got)
            checked += 1
    assert checked >= 8


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def conformer_engines():
    """A Conformer ASR model (rel-pos, kernel 5) served by both packages'
    ``Speech2Text`` on the same weights, beam 3, nbest 2."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg, _, variables, pm = _asr_models(seed=14)
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=3, nbest=2, unroll=1)
    js = JaxSpeech2Text(cfg)
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ps = Speech2Text(copy.deepcopy(cfg), device="cpu")
    ps.model.load_state_dict(pm.state_dict(), strict=True)
    batch = {k: speech_batch("asr")[k] for k in ("speech", "speech_lengths")}
    return cfg, js, ps, batch


def test_conformer_speech2text_greedy_and_nbest_match_jax(conformer_engines):
    """Greedy transcripts equal; beam 3, nbest 2: ids equal, scores within
    1e-4 (the beam's self-attention through the group attend's plain
    version, as K4 takes it on the card)."""
    from test_torch_port_beam import _same_nbest

    _, js, ps, batch = conformer_engines
    greedy = ps.greedy(batch)
    assert greedy == js.greedy(batch) and len(greedy) == 2
    _same_nbest(ps.nbest(batch), js.nbest(batch))


@pytest.mark.parametrize("token_type", ["word", None], ids=["word", "none"])
def test_word_and_none_token_types_match_jax(conformer_engines, token_type):
    """``token_type: word`` and none (a YAML null): greedy transcripts equal
    to the JAX engine's (tokens joined by spaces, ``<space>`` kept as a
    token); the nbest texts are their tokens joined by spaces."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg, js0, ps0, batch = conformer_engines
    cfg = copy.deepcopy(cfg)
    cfg.token_type = token_type
    js = JaxSpeech2Text(cfg)
    js.variables = js0.variables
    ps = Speech2Text(copy.deepcopy(cfg), device="cpu")
    ps.model.load_state_dict(ps0.model.state_dict(), strict=True)
    greedy = ps.greedy(batch)
    assert greedy == js.greedy(batch) and greedy != ps0.greedy(batch)
    assert all(" " in g for g in greedy)
    for hyps in ps.nbest(batch):
        for text, toks, _, _ in hyps:
            assert text == " ".join(toks)
