"""The port's train step against the JAX package, in f32 on the CPU: losses,
the hybrid CTC/attention loss graph and every parameter's gradient,
BatchNorm running statistics, the optimizer chain and its schedules,
SpecAug / stochastic depth / branch drop by their statistics, checkpoints,
the training CLI and a convergence canary.

Tolerances (stated per test; |got - want| <= atol + rtol * |want|):
- losses on random logits: 1e-5 relative (f32 sums in other orders);
- the loss graph (tiny flagship, weights through ``convert_jax_variables``):
  loss, loss_ctc, loss_att 1e-4 relative, acc exact; each gradient entry
  within 1e-4 of its tensor's largest JAX entry plus 1e-5 of the model's
  largest (an absolute floor for the tensors whose exact gradient is 0,
  such as key biases under a softmax). The audio stream is one frame
  shorter than the video's and padded with -1 (``_align``), where flax's
  LayerNorm cancels (the standing note of ROADMAP.md section 3); at this
  batch the gradients show no more of it than f32 rounding (largest
  difference 2.4e-6 deterministic, 9.7e-6 in train mode, against a largest
  gradient of about 2);
- BatchNorm running statistics after one train-mode step: within 1e-5 of
  each tensor's largest entry;
- one optimizer update against optax: 1e-6 absolute on O(1) parameters.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from tailored_avsr_tpu.ops import losses as jlosses
from tailored_avsr_tpu.tasks.avsr import AVSRTask
from tailored_avsr_tpu_torch.ops import losses as plosses
from tailored_avsr_tpu_torch.tasks.avsr import build_model
from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict
from tests.test_torch_port_slice import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = os.path.join(ROOT, "tokenizers/char/spanish.txt")
TOKEN_LIST = [line.rstrip() for line in open(TOKENS) if line.rstrip()]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs in several processes at
    once, and the trunk's CPU convolutions slow down many times over when
    every process spins one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- losses


def _ctc_case():
    rs = np.random.RandomState(0)
    b, t, v, l = 5, 12, 7, 6
    logits = rs.randn(b, t, v).astype(np.float32)
    lens = np.array([12, 10, 3, 12, 0], np.int32)  # row 2 infeasible, row 4 all padding
    labels = rs.randint(1, v, (b, l)).astype(np.int32)
    label_lens = np.array([6, 4, 5, 0, 0], np.int32)
    labels[1, 2] = labels[1, 1]  # an adjacent repeat
    for i, n in enumerate(label_lens):
        labels[i, n:] = -1
    return logits, lens, labels, label_lens


@pytest.mark.parametrize("reduce", [True, False])
def test_ctc_loss_matches_jax(reduce):
    """1e-5 relative on the loss, 1e-5 absolute on the gradient; the
    infeasible utterance (T=3 < L=5) and the all-padding row give 0 and no
    gradient."""
    logits, lens, labels, label_lens = _ctc_case()
    want = np.asarray(jlosses.ctc_loss(jnp.asarray(logits), lens, labels, label_lens, reduce=reduce))
    x = torch.tensor(logits, requires_grad=True)
    got = plosses.ctc_loss(x, torch.tensor(lens), torch.tensor(labels), torch.tensor(label_lens),
                           reduce=reduce)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    got.sum().backward()
    gwant = jax.grad(lambda z: jlosses.ctc_loss(z, lens, labels, label_lens, reduce=reduce).sum())(
        jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant), atol=1e-5)
    assert not x.grad[2].any() and not x.grad[4].any()
    if not reduce:
        assert got[2] == 0 and got[4] == 0


def test_ctc_feasibility_rule():
    from tailored_avsr_tpu_torch.ops.losses import ctc_feasible

    labels = torch.tensor([[1, 1, 2, -1], [1, 2, 3, 4], [3, 3, 3, -1]])
    label_lens = torch.tensor([3, 4, 3])
    # needs 4 (one repeat), 4, 5 (two repeats) frames
    assert ctc_feasible(torch.tensor([4, 4, 4]), labels, label_lens).tolist() == [True, True, False]
    assert ctc_feasible(torch.tensor([3, 3, 5]), labels, label_lens).tolist() == [False, False, True]


def test_add_sos_eos_and_token_accuracy_are_exact():
    rs = np.random.RandomState(1)
    text = rs.randint(1, 9, (4, 6)).astype(np.int32)
    for i, n in enumerate([6, 3, 0, 1]):
        text[i, n:] = -1
    ji, jo = jlosses.add_sos_eos(jnp.asarray(text), 9, 9)
    pi, po = plosses.add_sos_eos(torch.tensor(text), 9, 9)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    logits = rs.randn(4, 7, 10).astype(np.float32)
    assert float(plosses.token_accuracy(torch.tensor(logits), po)) == float(
        jlosses.token_accuracy(jnp.asarray(logits), jo))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax(smoothing, normalize_length):
    """1e-5 relative."""
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 5, 11).astype(np.float32)
    targets = rs.randint(0, 11, (3, 5))
    targets[1, 3:] = -1
    want = float(jlosses.label_smoothing_loss(jnp.asarray(logits), targets, smoothing, -1, normalize_length))
    got = float(plosses.label_smoothing_loss(torch.tensor(logits), torch.tensor(targets), smoothing, -1,
                                             normalize_length))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------- loss graph

_RATES = {"dropout_rate": 0.0, "positional_dropout_rate": 0.0}


def _train_cfg():
    """The tiny flagship with every dropout rate at 0 and no SpecAug, so the
    JAX train mode (deterministic=False) and the port's are the same
    function: BatchNorm batch statistics are the difference from eval."""
    cfg = graft._flagship_cfg(tiny=True)
    cfg.token_list = TOKENS
    cfg.specaug = None
    cfg.encoder_conf = dict(cfg.encoder_conf, attention_dropout_rate=0.0, **_RATES)
    cfg.decoder_conf = dict(cfg.decoder_conf, self_attention_dropout_rate=0.0,
                            src_attention_dropout_rate=0.0, **_RATES)
    cfg.acoustic_embed_conf = dict(cfg.acoustic_embed_conf, **_RATES)
    cfg.visual_embed_conf = dict(cfg.visual_embed_conf, **_RATES)
    cfg.audiovisual_fusion_conf = dict(cfg.audiovisual_fusion_conf, dropout_rate=0.0)
    cfg.ctc_conf = dict(cfg.ctc_conf, dropout_rate=0.0)
    return cfg


def _train_batch(b=2, frames=8, text_len=6):
    rs = np.random.RandomState(3)
    samples = frames * 640
    text = rs.randint(3, len(TOKEN_LIST) - 1, (b, text_len)).astype(np.int32)
    text[1, text_len - 2:] = -1
    return (
        (rs.randn(b, samples) * 0.1).astype(np.float32),
        np.array([samples, samples - 640], np.int32),
        rs.randn(b, frames, 88, 88).astype(np.float32),
        np.array([frames, frames - 1], np.int32),
        text,
        np.array([text_len, text_len - 2], np.int32),
    )


def _small_batch():
    """4 frames, 3 characters: the cheapest batch the loss graph takes whole."""
    return tuple(torch.from_numpy(a) for a in _train_batch(frames=4, text_len=3))


@pytest.fixture(scope="module")
def loss_graph():
    """One JAX compile: the loss, stats and parameter gradients with
    deterministic=True, and with deterministic=False (BatchNorm batch
    statistics) plus the updated batch_stats."""
    cfg = _train_cfg()
    jm = AVSRTask.build_model(cfg, TOKEN_LIST)
    batch = _train_batch()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)}, *batch))
    variables = _random_variables(shapes, seed=4)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "skip", "specaug"))}

    @jax.jit
    def run(params, batch_stats, *b):
        def det(p):
            return jm.apply({"params": p, "batch_stats": batch_stats}, *b, deterministic=True,
                            return_ctc_argmax=True)

        def train(p):
            (loss, stats), new = jm.apply({"params": p, "batch_stats": batch_stats}, *b,
                                          deterministic=False, rngs=rngs, mutable=["batch_stats"])
            return loss, (stats, new["batch_stats"])

        (l_det, s_det), g_det = jax.value_and_grad(det, has_aux=True)(params)
        (l_tr, (s_tr, bs)), g_tr = jax.value_and_grad(train, has_aux=True)(params)
        return l_det, s_det, g_det, l_tr, s_tr, g_tr, bs

    out = jax.device_get(run(variables["params"], variables["batch_stats"], *batch))
    return {"cfg": cfg, "variables": variables, "batch": batch, "jax": out}


def _port_model(loss_graph):
    model = build_model(loss_graph["cfg"], TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(loss_graph["variables"], model)
    assert dropped == []
    model.load_state_dict(sd, strict=True)
    return model


def _port_loss(model, batch, train: bool):
    model.train(train)
    model.zero_grad()
    loss, stats = model(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    return loss, stats


def _check_grads(model, jax_grads):
    """Every parameter's gradient: the JAX gradient tree has the
    parameters' structure, and every map of the export is a transpose or a
    rename (``_from_flax``), so the same map carries it to the port's keys."""
    want = {k: np.asarray(v) for k, v in export_torch_state_dict({"params": jax_grads}).items()}
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for name, p in named.items():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=floor + 1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("train", [False, True], ids=["deterministic", "train_mode"])
def test_loss_graph_and_gradients_match_jax(loss_graph, train):
    """loss, loss_ctc, loss_att 1e-4 relative, acc exact, every gradient as
    the module docstring states."""
    l_det, s_det, g_det, l_tr, s_tr, g_tr, _ = loss_graph["jax"]
    want_loss, want_stats, want_grads = (l_tr, s_tr, g_tr) if train else (l_det, s_det, g_det)
    model = _port_model(loss_graph)
    loss, stats = _port_loss(model, loss_graph["batch"], train)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    for key in ("loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(stats[key].detach()), float(want_stats[key]), rtol=1e-4)
    assert float(stats["acc"]) == float(want_stats["acc"])
    _check_grads(model, want_grads)


def test_batchnorm_running_stats_match_jax(loss_graph):
    """One train-mode step moves every BatchNorm's running mean and variance
    as flax's does (biased batch variance, momentum 0.9): within 1e-5 of
    the tensor's largest entry (a mean near 0 is a sum of f32 terms in
    another order)."""
    bs = loss_graph["jax"][-1]
    want = export_torch_state_dict({"params": loss_graph["variables"]["params"], "batch_stats": bs})
    model = _port_model(loss_graph)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    _port_loss(model, loss_graph["batch"], train=True)
    got = model.state_dict()
    assert len(before) == 2 * 20  # the stem's and 19 trunk BatchNorms
    for k in before:
        assert not torch.equal(got[k], before[k]), k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_batchnorm_momentum_is_flax_09():
    from tailored_avsr_tpu_torch.models.frontends import Conv3dResNet18

    bns = [m for m in Conv3dResNet18().modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(bns) == 20 and all(m.momentum == 0.1 and m.eps == 1e-5 for m in bns)


def test_biased_running_variance_differs_from_torch_default():
    """The witness: torch's BatchNorm2d moves the running variance by the
    unbiased batch variance, n/(n-1) apart from flax's, which the port's
    matches exactly."""
    from tailored_avsr_tpu_torch.models.frontends import FlaxBatchNorm2d

    x = torch.randn(2, 3, 3, 3, generator=torch.Generator().manual_seed(0))  # n = 18 per channel
    flax_bn, torch_bn = FlaxBatchNorm2d(3, momentum=0.1), torch.nn.BatchNorm2d(3, momentum=0.1)
    y1, y2 = flax_bn(x), torch_bn(x)
    torch.testing.assert_close(y1, y2)  # the normalisation agrees
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(flax_bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(torch_bn.running_var, 0.9 + 0.1 * var * 18 / 17)


# ---------------------------------------------------------------- optimizer


def _tree(rs):
    return {"encoder": {"w": rs.randn(4, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)},
            "decoder": {"w": rs.randn(5).astype(np.float32)}}


def _run_both(ts, steps, frozen_decoder=True, seed=0):
    from tailored_avsr_tpu.train.optim import set_optimizer as jset
    from tailored_avsr_tpu_torch.train.optim import set_optimizer as pset

    rs = np.random.RandomState(seed)
    params = _tree(rs)
    mask = {"encoder": {"w": False, "b": False}, "decoder": {"w": frozen_decoder}}
    tx, _ = jset(ts, 16, 4, frozen_mask=mask if frozen_decoder else None)
    st, jp = tx.init(params), params
    tp = {f"{m}.{k}": torch.nn.Parameter(torch.tensor(v)) for m, d in params.items() for k, v in d.items()}
    opt, _ = pset(ts, 16, 4, list(tp.items()), frozen=["decoder.w"] if frozen_decoder else [])
    for _ in range(steps):
        g = _tree(rs)
        u, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, u)
        for m, d in g.items():
            for k, v in d.items():
                tp[f"{m}.{k}"].grad = torch.tensor(v)
        opt.step()
    return params, jp, tp


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_one_clipped_noam_update_with_a_frozen_module_matches_optax(optimizer):
    """1e-6 absolute on O(1) parameters; the clip binds (global norm about
    4.7 > 1) and the frozen module does not move."""
    ts = {"optimizer": optimizer, "scheduler": "noam", "noam_factor": 1.6, "warmup_steps": 10,
          "grad_clip": 1.0, "accum_grad": 1}
    start, jp, tp = _run_both(ts, 1)
    for m in jp:
        for k in jp[m]:
            np.testing.assert_allclose(tp[f"{m}.{k}"].detach().numpy(), np.asarray(jp[m][k]), atol=1e-6)
    assert np.array_equal(tp["decoder.w"].detach().numpy(), start["decoder"]["w"])
    assert not np.array_equal(tp["encoder.w"].detach().numpy(), start["encoder"]["w"])


@pytest.mark.parametrize("scheduler", ["noam", "onecycle", "constant"])
def test_accum_grad_2_matches_multisteps(scheduler):
    """Four micro-steps with accum_grad 2 (two updates) against
    optax.MultiSteps: 1e-6 absolute, no frozen module, no clip."""
    ts = {"optimizer": "adam", "scheduler": scheduler, "noam_factor": 1.6, "warmup_steps": 10,
          "learning_rate": 1e-3, "accum_grad": 2, "epochs": 2}
    start, jp, tp = _run_both(ts, 4, frozen_decoder=False, seed=5)
    for m in jp:
        for k in jp[m]:
            np.testing.assert_allclose(tp[f"{m}.{k}"].detach().numpy(), np.asarray(jp[m][k]), atol=1e-6)


def test_accumulating_micro_step_moves_nothing():
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = set_optimizer({"accum_grad": 3}, 16, 1, [("w", p)])
    for i in range(3):
        p.grad = torch.ones(3)
        assert opt.step() == (i == 2)
        assert (p == 1).all() == (i < 2)
        assert p.grad is None


def test_schedules_match_optax():
    """Noam and OneCycle at steps 0, 1, the warmup / peak step and the end:
    1e-5 relative (the JAX side evaluates in f32, the port in f64)."""
    from tailored_avsr_tpu.train.optim import noam_schedule as jnoam
    from tailored_avsr_tpu.train.optim import onecycle_schedule as jone
    from tailored_avsr_tpu_torch.train.optim import noam_schedule, onecycle_schedule

    for step in (0, 1, 9999, 10000, 250000):
        np.testing.assert_allclose(noam_schedule(256, 1.6, 10000)(step), float(jnoam(256, 1.6, 10000)(step)),
                                   rtol=1e-5)
    for step in (0, 1, 30, 100, 150):
        np.testing.assert_allclose(onecycle_schedule(1e-3, 100)(step), float(jone(1e-3, 100)(step)), rtol=1e-5)


def test_unknown_scheduler_and_optimizer_raise():
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    p = [("w", torch.nn.Parameter(torch.ones(1)))]
    with pytest.raises(ValueError, match="scheduler"):
        set_optimizer({"scheduler": "cosine"}, 16, 1, p)
    with pytest.raises(ValueError, match="optimizer"):
        set_optimizer({"optimizer": "sgd"}, 16, 1, p)


# ------------------------------------------------- randomness, by statistics


def test_specaug_identity_when_every_mask_is_off():
    from tailored_avsr_tpu_torch.ops.specaug import SpecAug

    x = torch.randn(3, 40, 20)
    lens = torch.tensor([40, 30, 7])
    aug = SpecAug(apply_time_warp=False, apply_freq_mask=False, apply_time_mask=False).train()
    y, ylens = aug(x, lens, torch.Generator().manual_seed(0))
    assert torch.equal(y, x) and torch.equal(ylens, lens)
    assert torch.equal(aug.eval()(x, lens)[0], x)


def test_specaug_widths_counts_and_lengths():
    """Over 400 utterances: frequency masks of width in [0, 27), two per
    utterance; time masks of width in [0, max(int(0.05 L), 1)) inside each
    utterance's length, five per utterance; lengths unchanged; the means
    of the widths near their distributions' means."""
    from tailored_avsr_tpu_torch.ops.specaug import SpecAug

    b, t, f = 400, 200, 80
    lens = torch.randint(60, t + 1, (b,), generator=torch.Generator().manual_seed(1))
    x = torch.ones(b, t, f)
    aug = SpecAug(apply_time_warp=False, apply_time_mask=False).train()
    y, ylens = aug(x, lens, torch.Generator().manual_seed(2))
    assert torch.equal(ylens, lens)
    freq_masked = (y == 0).all(dim=1)  # (B, F) channels masked over all frames
    widths = freq_masked.sum(dim=1).float()
    assert widths.max() <= 2 * 26
    # two independent widths uniform on [0, 27): mean 26, less overlaps
    assert 20 < widths.mean() < 27
    aug = SpecAug(apply_time_warp=False, apply_freq_mask=False).train()
    y, _ = aug(x, lens, torch.Generator().manual_seed(3))
    time_masked = (y == 0).all(dim=2)  # (B, T)
    pos = torch.arange(t)[None, :]
    assert not (time_masked & (pos >= lens[:, None])).any()  # never past the length
    per = time_masked.sum(dim=1).float()
    max_w = torch.clamp((0.05 * lens.float()).long(), min=1).float()
    assert (per <= 5 * (max_w - 1)).all()
    ratio = (per / (5 * (max_w - 1) / 2).clamp(min=1)).mean()
    assert 0.7 < ratio < 1.1  # five widths uniform on [0, max_w), less overlaps


def test_time_warp_keeps_padding_and_endpoints():
    from tailored_avsr_tpu_torch.ops.specaug import time_warp

    x = torch.arange(30.0)[None, :, None].repeat(4, 1, 2)
    lens = torch.tensor([30, 20, 11, 12])
    u = torch.rand(4, 2, generator=torch.Generator().manual_seed(0))
    y = time_warp(x, lens, 5, u)
    assert torch.equal(y[1, 20:], x[1, 20:])  # padding untouched
    assert torch.equal(y[2], x[2])  # length 11 <= 2 * 5 + 1: identity
    assert (y[:, 0] == 0).all()
    assert (torch.diff(y[0, :, 0]) >= 0).all()  # a monotone remap


def test_stochastic_depth_rate_and_coefficient():
    """A layer is skipped (its inputs returned) with probability p: 300
    coins at p = 0.3 give a rate within 5 standard deviations; a kept
    layer's branch residuals are scaled by 1 / (1 - p)."""
    from tailored_avsr_tpu_torch.models.tailored import TailoredEncoderLayer
    from tailored_avsr_tpu_torch.utils.initialize import init_params_

    layer = TailoredEncoderLayer(64, True, False, linear_units=96, cgmlp_linear_units=96, cgmlp_conv_kernel=7,
                                 stochastic_depth_rate=0.3)
    init_params_(layer, torch.Generator().manual_seed(0)).train()
    a, v = torch.randn(1, 4, 64), torch.randn(1, 4, 64)
    pos = torch.randn(1, 7, 64)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        skipped = sum(all(o is i for o, i in zip(layer(a, pos, None, v, pos, None, g), (a, v)))
                      for _ in range(300))
    assert abs(skipped / 300 - 0.3) < 5 * (0.3 * 0.7 / 300) ** 0.5
    # the coefficient: p = 0 against the same layer at p = 0.5, not skipped
    layer.stochastic_depth_rate = 0.0
    with torch.no_grad():
        base = layer(a, pos, None, v, pos, None)
        layer.stochastic_depth_rate = 0.5
        for seed in range(20):
            out = layer(a, pos, None, v, pos, None, torch.Generator().manual_seed(seed))
            if out[0] is not a:
                break
        layer.stochastic_depth_rate = 0.0
        assert not torch.allclose(out[0], base[0])
    assert layer.eval()(a, pos, None, v, pos, None)[0] is not a


def test_acoustic_branch_drop_rate():
    """One coin per step at p = 0.4 sets the fusion weights to (0, 1) for
    the whole batch; over 300 steps the rate is within 5 standard deviations."""
    from tailored_avsr_tpu_torch.models.fusion import AdaptiveAudioVisualFusion
    from tailored_avsr_tpu_torch.utils.initialize import init_params_

    fusion = AdaptiveAudioVisualFusion(64, 96, acoustic_branch_drop_rate=0.4)
    init_params_(fusion, torch.Generator().manual_seed(0)).train()
    a, v = torch.randn(3, 5, 64), torch.randn(3, 5, 64)
    mask = torch.ones(3, 5, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    drops = 0
    with torch.no_grad():
        for _ in range(300):
            w = fusion(a, mask, v, mask, g)[2]["acoustic_weight"]
            assert (w == 0).all() or (w > 0).all()
            drops += int((w == 0).all())
        assert (fusion.eval()(a, mask, v, mask)[2]["acoustic_weight"] > 0).all()
    assert abs(drops / 300 - 0.4) < 5 * (0.4 * 0.6 / 300) ** 0.5


def test_train_steps_are_reproducible_from_the_seed():
    """Dropout, SpecAug and the coins come from ``TrainState.generator``:
    two runs from one seed give identical losses, another seed others."""
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    cfg = graft._flagship_cfg(tiny=True)  # dropout 0.1, SpecAug on
    cfg.encoder_conf = dict(cfg.encoder_conf, stochastic_depth_rate=0.2)
    batch = _small_batch()

    def run(seed):
        model = build_model(cfg, TOKEN_LIST, device="cpu")
        opt, _ = set_optimizer({"accum_grad": 1}, 64, 1, model.named_parameters())
        state = create_train_state(model, opt, seed=seed)
        step = make_train_step()
        return [float(step(state, batch)[1]["loss"]) for _ in range(2)]

    first = run(0)
    assert run(0) == first
    assert run(1) != first


@pytest.mark.parametrize("ctc_weight", [0.0, 1.0])
def test_ctc_weight_ends(ctc_weight):
    """ctc_weight 0: the attention loss alone (no CTC term); 1: the CTC loss
    alone, and no decoder is built (as the JAX task builds none)."""
    cfg = _train_cfg()
    cfg.model_conf = dict(cfg.model_conf, ctc_weight=ctc_weight)
    model = build_model(cfg, TOKEN_LIST, device="cpu")
    with torch.no_grad():
        loss, stats = model(*(torch.from_numpy(a) for a in _train_batch()))
    if ctc_weight == 0.0:
        assert "loss_ctc" not in stats and float(loss) == float(stats["loss_att"])
    else:
        assert model.decoder is None and "loss_att" not in stats
        assert float(loss) == float(stats["loss_ctc"])


# ---------------------------------------------------------------- checkpoints


@pytest.fixture()
def small_model():
    return build_model(_train_cfg(), TOKEN_LIST, device="cpu")


def test_save_load_round_trip(small_model, tmp_path):
    from tailored_avsr_tpu_torch.train.checkpoint import load_model, save_model

    path = str(tmp_path / "m.pth")
    save_model(small_model, path)
    other = build_model(_train_cfg(), TOKEN_LIST, generator=torch.Generator().manual_seed(9), device="cpu")
    load_model(other, path)
    for (k, a), (_, b) in zip(small_model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k


def test_average_models_is_the_mean(tmp_path):
    from tailored_avsr_tpu_torch.train.checkpoint import average_models, save_model

    from tailored_avsr_tpu_torch.models.frontends import BasicBlock

    models = []
    for s in range(3):
        torch.manual_seed(s)
        block = BasicBlock(4, 8, stride=2).train()
        block(torch.randn(2, 4, 6, 6))  # moves the BatchNorm statistics
        models.append(block)
    paths = [str(tmp_path / f"m{s}.pth") for s in range(3)]
    for m, p in zip(models, paths):
        save_model(m, p)
    avg = average_models(paths)
    for k, v in avg.items():
        if v.is_floating_point():
            want = sum(m.state_dict()[k].double() for m in models) / 3
            torch.testing.assert_close(v, want.float(), rtol=0, atol=1e-7)


def test_load_e2e_per_module_and_freeze_mask(small_model, tmp_path):
    from tailored_avsr_tpu_torch.train.checkpoint import freeze_mask, load_e2e, save_model

    path = str(tmp_path / "m.pth")
    save_model(small_model, path)
    other = build_model(_train_cfg(), TOKEN_LIST, generator=torch.Generator().manual_seed(9), device="cpu")
    before = {k: v.clone() for k, v in other.state_dict().items()}
    load_e2e(other, path, ["encoder", "frontend"])
    for k, v in other.state_dict().items():
        top = k.split(".")[0]
        src = small_model.state_dict()[k] if top in ("encoder", "visual_frontend") else before[k]
        assert torch.equal(v, src), k
    frozen = freeze_mask(other, ["decoder", "ctc"])
    assert frozen and all(n.split(".")[0] in ("decoder", "ctc") for n in frozen)
    assert len(frozen) == sum(1 for n, _ in other.named_parameters() if n.split(".")[0] in ("decoder", "ctc"))


def test_port_checkpoint_loads_into_the_jax_package(loss_graph, tmp_path):
    """A port ``.pth`` read by the JAX ``load_model`` gives the port's
    parameters and BatchNorm statistics exactly."""
    from tailored_avsr_tpu.train.checkpoint import load_model as jax_load_model
    from tailored_avsr_tpu_torch.train.checkpoint import save_model

    model = _port_model(loss_graph)
    _port_loss(model, loss_graph["batch"], train=True)  # moves the BatchNorm statistics
    path = str(tmp_path / "port.pth")
    save_model(model, path)
    template = jax.tree_util.tree_map(np.zeros_like, loss_graph["variables"])
    loaded = export_torch_state_dict(jax_load_model(template, path))
    state = model.state_dict()
    assert set(loaded) == {k for k in state if not k.endswith("num_batches_tracked")}
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, state[k].numpy(), err_msg=k)


def test_train_state_resume_is_exact(tmp_path):
    """A step from a restored train state equals the step from the live one
    (the same loss, the same parameters), accumulation included."""
    from tailored_avsr_tpu_torch.train.checkpoint import load_train_state, save_train_state
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer

    cfg = graft._flagship_cfg(tiny=True)
    batch = _small_batch()
    ts = {"accum_grad": 2, "grad_clip": 5.0}

    def fresh():
        model = build_model(cfg, TOKEN_LIST, device="cpu")
        opt, _ = set_optimizer(ts, 64, 1, model.named_parameters())
        return create_train_state(model, opt, seed=3)

    step = make_train_step()
    live = fresh()
    for _ in range(3):
        step(live, batch)
    path = str(tmp_path / "train_state.pt")
    save_train_state(live, 7, path)
    restored, epoch = load_train_state(fresh(), path)
    assert epoch == 7 and restored.step == 3 and restored.optimizer.mini_step == 1
    _, s_live = step(live, batch)
    _, s_rest = step(restored, batch)
    assert float(s_live["loss"]) == float(s_rest["loss"])
    for (k, a), (_, b) in zip(live.model.state_dict().items(), restored.model.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- eval step


def test_eval_step_matches_the_jax_eval(loss_graph):
    """``make_eval_step``: the deterministic loss (1e-4 relative) and greedy
    CTC ids equal to the JAX model's on the same weights."""
    from tailored_avsr_tpu_torch.train.loop import TrainState, make_eval_step

    batch, want = loss_graph["batch"], loss_graph["jax"][1]
    model = _port_model(loss_graph).train()
    state = TrainState(0, model, None, None, torch.Generator())
    out = make_eval_step()(state, tuple(torch.from_numpy(a) for a in batch))
    assert not model.training
    np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), rtol=1e-4)
    lens = np.asarray(want["ctc_argmax_lens"])
    np.testing.assert_array_equal(out["ctc_argmax_lens"].numpy(), lens)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(out["ctc_argmax"][i, :n].numpy(), np.asarray(want["ctc_argmax"])[i, :n])


# ---------------------------------------------------------------- task factory


def test_constructor_tables_cover_the_jax_fields():
    """Each key a JAX constructor takes is a port constructor argument or in
    the task factory's ``*_FIXED`` table (built, or refused naming its item)."""
    import dataclasses

    from tailored_avsr_tpu.models.decoder import TransformerDecoder as JD
    from tailored_avsr_tpu.models.frontends import Conv3dResNet18 as JC
    from tailored_avsr_tpu.models.fusion import AdaptiveAudioVisualFusion as JF
    from tailored_avsr_tpu.models.tailored import TailoredEncoder as JT
    from tailored_avsr_tpu.ops.specaug import SpecAug as JS
    from tailored_avsr_tpu.tasks.common import _DROPPED_KEY_ALLOWED
    from tailored_avsr_tpu_torch.models.decoder import TransformerDecoder
    from tailored_avsr_tpu_torch.models.frontends import Conv3dResNet18
    from tailored_avsr_tpu_torch.models.fusion import AdaptiveAudioVisualFusion
    from tailored_avsr_tpu_torch.models.tailored import TailoredEncoder
    from tailored_avsr_tpu_torch.ops.normalize import UtteranceMVN
    from tailored_avsr_tpu_torch.ops.specaug import SpecAug
    from tailored_avsr_tpu_torch.tasks import common as task
    from tailored_avsr_tpu.ops.normalize import UtteranceMVN as JU

    pairs = [(JT, TailoredEncoder, {}), (JD, TransformerDecoder, {}),
             (JC, Conv3dResNet18, task.VISUAL_FRONTEND_FIXED), (JF, AdaptiveAudioVisualFusion, {}),
             (JS, SpecAug, {}), (JU, UtteranceMVN, {})]
    for jcls, pcls, fixed in pairs:
        jfields = {f.name for f in dataclasses.fields(jcls)} - {"parent", "name"}
        pnames = task.constructor_names(pcls)
        assert jfields <= pnames | set(fixed), (jcls.__name__, sorted(jfields - pnames - set(fixed)))
        assert set(fixed) <= jfields - pnames, (jcls.__name__, sorted(set(fixed) - jfields))
    assert task.DROPPED_KEY_ALLOWED == _DROPPED_KEY_ALLOWED


def test_bn_axis_name_builds_the_same_model_and_its_train_forward_raises_as_jax():
    """``visual_frontend_conf bn_axis_name`` (once refused, naming item 9)
    builds the model it builds without it (the same seeded weights), and a
    train-mode forward raises the ``NameError`` the JAX train step raises;
    the VSR case against the JAX model: ``tests/test_torch_port_parallel.py``."""
    cfg = _train_cfg()
    plain = build_model(cfg, TOKEN_LIST, device="cpu")
    cfg.visual_frontend_conf = dict(cfg.visual_frontend_conf or {}, bn_axis_name="data")
    model = build_model(cfg, TOKEN_LIST, device="cpu")
    want = plain.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(v, want[k]) for k, v in got.items())
    with pytest.raises(NameError, match="unbound axis name: data"):
        _port_loss(model, _train_batch(frames=4, text_len=3), train=True)


def test_training_fields_build():
    cfg = graft._flagship_cfg(tiny=True)
    cfg.encoder_conf = dict(cfg.encoder_conf, stochastic_depth_rate=[0.1, 0.2], acoustic_branch_drop_rate=0.3,
                            positional_dropout_rate=0.2)
    cfg.audiovisual_fusion_conf = dict(cfg.audiovisual_fusion_conf, acoustic_branch_drop_rate=0.25)
    cfg.visual_frontend_conf = dict(cfg.visual_frontend_conf, stem_s2d=False)
    model = build_model(cfg, TOKEN_LIST, device="cpu")
    assert [layer.stochastic_depth_rate for layer in model.encoder.encoders] == [0.1, 0.2]
    assert model.audiovisual_fusion.acoustic_branch_drop_rate == 0.25
    assert model.specaug is not None and model.specaug.num_time_mask == 5
    assert (model.ctc_weight, model.lsm_weight) == (0.1, 0.1)
    assert not model.training  # built for serving; the train step sets train mode


def test_serving_builds_no_differently(monkeypatch):
    """A model built for serving is in eval mode: SpecAug, dropout and the
    coins are inert, and the greedy path gives the same ids as before."""
    cfg = graft._flagship_cfg(tiny=True)
    cfg.encoder_conf = dict(cfg.encoder_conf, stochastic_depth_rate=0.9)
    model = build_model(cfg, TOKEN_LIST, device="cpu")
    b = _train_batch()
    args = tuple(torch.from_numpy(a) for a in b[:4])
    with torch.no_grad():
        ids1, _ = model.ctc_greedy(*args)
        ids2, _ = model.ctc_greedy(*args)
    assert torch.equal(ids1, ids2)


# ---------------------------------------------------------------- CLI


def _cli_config(tmp_path, token_path, **training):
    import yaml

    with open(os.path.join(ROOT, "configs/tests/avsr_tiny.yaml")) as f:
        c = yaml.safe_load(f)
    c["token_list"] = token_path
    c["training_settings"].update(training)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    return path


@pytest.fixture()
def corpus(tmp_path):
    from tests.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(str(tmp_path / "corpus"), n=3)


def _cli_args(cfg, csv_path, out_dir, mode="both"):
    return ["--config-file", cfg, "--training-dataset", csv_path, "--validation-dataset", csv_path,
            "--test-dataset", csv_path, "--mode", mode, "--output-dir", out_dir, "--output-name", "t",
            "--device", "cpu"]


def test_cli_trains_validates_averages_and_decodes(corpus, tmp_path):
    from tailored_avsr_tpu_torch import avsr_main

    csv_path, token_path = corpus
    cfg = _cli_config(tmp_path, token_path, epochs=2, average_epochs=2, batch_size=3)
    out = str(tmp_path / "exp")
    avsr_main.main(_cli_args(cfg, csv_path, out))
    models = sorted(os.listdir(os.path.join(out, "models")))
    assert models == ["model_001.pth", "model_002.pth", "model_average.pth", "train_state.pt"]
    with open(os.path.join(out, "val_stats.csv")) as f:
        assert f.readline().strip() == "epoch,cer" and len(f.readlines()) == 2
    with open(os.path.join(out, "inference", "t.inf")) as f:
        assert len(f.readlines()) == 3
    with open(os.path.join(out, "inference", "t.wer")) as f:
        assert f.readline().startswith("WER: ")


def test_cli_resume_retrains_the_interrupted_epoch(corpus, tmp_path, monkeypatch):
    """SIGTERM during epoch 2 abandons it (epoch 1's state is on disk);
    ``--resume`` re-trains epoch 2 and finishes."""
    import signal

    from tailored_avsr_tpu_torch import avsr_main

    csv_path, token_path = corpus
    cfg = _cli_config(tmp_path, token_path, epochs=2, average_epochs=1, batch_size=3)
    out = str(tmp_path / "exp")
    handlers = {}
    real_make = avsr_main.make_train_step
    calls = {"n": 0}

    def make(*a, **k):
        step = real_make(*a, **k)

        def wrapped(*sa):
            calls["n"] += 1
            if calls["n"] == 2:  # one batch an epoch: call 2 is epoch 2's step
                handlers[signal.SIGTERM](signal.SIGTERM, None)
            return step(*sa)

        return wrapped

    monkeypatch.setattr(avsr_main.signal, "signal", lambda s, h: handlers.__setitem__(s, h))
    monkeypatch.setattr(avsr_main, "make_train_step", make)
    avsr_main.main(_cli_args(cfg, csv_path, out, "training"))
    models = os.path.join(out, "models")
    assert sorted(os.listdir(models)) == ["model_001.pth", "train_state.pt"]
    monkeypatch.setattr(avsr_main, "make_train_step", real_make)
    avsr_main.main(_cli_args(cfg, csv_path, out, "training") + ["--resume"])
    assert sorted(os.listdir(models)) == ["model_001.pth", "model_002.pth", "model_average.pth",
                                          "train_state.pt"]
    assert calls["n"] == 2


def test_cli_data_parallel_on_one_process_trains_as_without_it(corpus, tmp_path, capsys):
    """``training_settings data_parallel: true`` (once refused, naming item 9)
    on one process trains as without it, as the JAX CLI builds its mesh
    only over more than one device: no grid, the same checkpoint. Over two
    ranks: ``tests/test_torch_port_parallel.py``."""
    from tests.torch_port_parallel_ranks import cli

    csv_path, token_path = corpus
    cfg = _cli_config(tmp_path, token_path, epochs=1, average_epochs=1)
    outs = []
    for extra in ([], ["--yaml-overrides", "training_settings:data_parallel:true"]):
        out = str(tmp_path / f"exp{len(outs)}")
        cli(_cli_args(cfg, csv_path, out, "training") + extra)  # the eval transforms: the same batches
        outs.append(torch.load(os.path.join(out, "models", "model_001.pth"), weights_only=True))
    assert "training grid" not in capsys.readouterr().out
    assert outs[0].keys() == outs[1].keys() and all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])


def test_cli_ngram_file_and_missing_card_raise(corpus, tmp_path):
    """The CLI's default device is the card: without one it raises. (The
    CLI with ``--ngram-file`` decodes: ``tests/test_torch_port_ngram_quantize.py``.)"""
    from tailored_avsr_tpu_torch import avsr_main

    csv_path, token_path = corpus
    cfg = _cli_config(tmp_path, token_path)
    args = _cli_args(cfg, csv_path, str(tmp_path / "exp"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            avsr_main.main(args[:-2])  # the default device is the card


def test_cli_module_runs_as_a_script(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "tailored_avsr_tpu_torch.avsr_main", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout


# ---------------------------------------------------------------- canary


@pytest.mark.slow
def test_port_memorizes_synthetic_corpus(tmp_path):
    """Twin of ``tests/test_convergence.py`` for the port: the tiny hybrid
    model memorises 4 synthetic utterances (Noam factor 1, warmup 100, clip
    5) until greedy CTC CER < 20 % and the loss halves. Slow like its twin:
    about 60 s on 8 CPU cores (it stops at its first check, step 150, with
    CER 0 and loss 0.09); ``chip_smoke.py`` runs a canary of the 64-d tiny
    flagship on the card."""
    from tests.synthetic import make_synthetic_corpus
    from tailored_avsr_tpu_torch.data.dataloader import AVSRDataLoader
    from tailored_avsr_tpu_torch.data.dataset import AVSRDataset
    from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
    from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse
    from tailored_avsr_tpu_torch.evaluation.wer import cer_from_ids
    from tailored_avsr_tpu_torch.train.loop import create_train_state, make_eval_step, make_train_step
    from tailored_avsr_tpu_torch.train.optim import set_optimizer
    from tailored_avsr_tpu_torch.utils.config import load_config

    csv, tokens = make_synthetic_corpus(str(tmp_path / "corpus"), n=4, seed=0, nframes=12)
    cfg = load_config(os.path.join(ROOT, "configs", "tests", "avsr_tiny.yaml"))
    cfg.token_list = tokens
    tokenizer, converter = get_tokenizer_converter(cfg)
    model = build_model(cfg, converter.token_list, device="cpu")
    loader = AVSRDataLoader(AVSRDataset(csv, task="avsr", is_training=False), 4, task="avsr",
                            tokenizer=tokenizer, converter=converter, is_training=False)
    batch = next(iter(loader))
    bt = tuple(torch.as_tensor(batch[k]) for k in (
        "audio", "audio_lengths", "video", "video_lengths", "text", "text_lengths"))
    ts = {"optimizer": "adam", "scheduler": "noam", "noam_factor": 1.0, "warmup_steps": 100,
          "grad_clip": 5.0, "accum_grad": 1, "epochs": 1}
    opt, _ = set_optimizer(ts, 32, 1, model.named_parameters())
    state = create_train_state(model, opt)
    train_step, eval_step = make_train_step(), make_eval_step()
    refs = [list(t[:n]) for t, n in zip(batch["text"], batch["text_lengths"])]
    first = last = None
    best_cer = 100.0
    for i in range(600):
        _, stats = train_step(state, bt)
        last = float(stats["loss"])
        first = last if first is None else first
        if i >= 149 and (i + 1) % 25 == 0:
            out = eval_step(state, bt)
            hyp = ctc_greedy_collapse(out["ctc_argmax"].numpy(), out["ctc_argmax_lens"].numpy())
            best_cer = min(best_cer, cer_from_ids(refs, hyp))
            if best_cer < 20.0 and last < 0.5:
                break
    assert best_cer < 20.0, f"best CER {best_cer}% (loss {first:.2f} -> {last:.2f})"
    assert last < 0.5 * first, (first, last)
