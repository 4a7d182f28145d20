"""The rest of the recipe in the port, against the JAX package on the CPU:
``remat`` in the train step, a config ``init`` scheme, and the four
scripts the port runs with ``python -m`` (``study_adaptive_fusion``,
``average_model``, ``get_val_accs``, ``compute_flops``).

Tolerances (stated per test):
- a ``remat`` step against the plain port step: loss and every gradient
  within 1e-6, BatchNorm running statistics equal (the recompute runs the
  same ops on the same values and leaves the statistics be);
- a ``remat`` step against the JAX ``make_train_step(remat=True)``: the
  tolerances of ``tests/test_torch_port_train.py``'s loss graph (loss 1e-4
  relative, each gradient within 1e-4 of its tensor's largest entry plus
  1e-5 of the model's largest, BatchNorm statistics within 1e-5 of the
  tensor's largest);
- ``init``: each leaf's class (kept, zeros, ones, redrawn) equal in both
  packages; a redrawn leaf of >= 4096 entries has a sample std within 10 %
  of the scheme's (flax's variance-scaling fans) in both;
- the scripts: fusion weights within 1e-5, averaged tensors equal (f64
  means cast back), ``val_accs.csv`` rows equal, parameter counts equal.
"""

import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import __graft_entry__ as graft
from test_torch_port_branchformer import ASR, speech_batch, tiny_cfg
from test_torch_port_slice import _random_variables
from test_torch_port_train import TOKEN_LIST, TOKENS, _check_grads, _small_batch, _train_batch, _train_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test (the suite runs in several processes,
    and the ResNet trunk's CPU convolutions slow down under contention)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- remat


class _Grads:
    """An optimizer stand-in for the train step: keeps the micro-step's
    gradients and clears them, as ``Optimizer.step`` does."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def step(self):
        self.grads = {n: p.grad.clone() for n, p in self.model.named_parameters() if p.grad is not None}
        self.model.zero_grad(set_to_none=True)


def _port_step(model, batch, remat, seed=5):
    from tailored_avsr_tpu_torch.train.loop import TrainState, make_train_step

    rec = _Grads(model)
    state = TrainState(step=0, model=model, optimizer=rec, schedule=None,
                       generator=torch.Generator().manual_seed(seed))
    _, stats = make_train_step(remat=remat)(state, batch)
    stats_bn = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    return float(stats["loss"]), rec.grads, stats_bn


def _family(name):
    """(cfg, batch) of the tiny flagship or the tiny ASR Branchformer with
    dropout 0.1, SpecAug on and stochastic depth (and, for the ASR
    Branchformer, branch drop) at 0.3."""
    from tailored_avsr_tpu_torch.utils.config import load_config

    if name == "flagship":
        cfg = graft._flagship_cfg(tiny=True)
        cfg.token_list = TOKENS
        cfg.encoder_conf = dict(cfg.encoder_conf, stochastic_depth_rate=0.3)
        return cfg, _small_batch()
    cfg = tiny_cfg(ASR, stochastic_depth_rate=0.3, attn_branch_drop_rate=0.3)
    cfg.encoder_conf["dropout_rate"] = 0.1
    full = load_config(os.path.join(ROOT, ASR))
    cfg.specaug, cfg.specaug_conf = full.specaug, full.specaug_conf
    b = speech_batch("asr")
    return cfg, tuple(torch.from_numpy(b[k]) for k in ("speech", "speech_lengths", "text", "text_lengths"))


@pytest.mark.parametrize("family", ["flagship", "asr_branchformer"])
def test_remat_step_equals_the_plain_step(family, monkeypatch):
    """Two train steps from the same weights and seed, plain and with
    ``remat``: the same loss, gradients and BatchNorm statistics, and the
    ``remat`` step did run its regions through the checkpoint."""
    from tailored_avsr_tpu_torch.models import remat
    from tailored_avsr_tpu_torch.tasks.common import build_model

    cfg, batch = _family(family)
    regions = []
    real = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint", lambda fn, *a, **k: regions.append(fn) or real(fn, *a, **k))
    runs = []
    for on in (False, True):
        model = build_model(cfg, TOKEN_LIST, generator=torch.Generator().manual_seed(0), device="cpu")
        runs.append(_port_step(model, batch, on))
    (l0, g0, bn0), (l1, g1, bn1) = runs
    # the decoder's layers and the kept encoder layers, plus the trunk's four stages for the flagship
    assert len(regions) >= 2 + (4 if family == "flagship" else 0)
    assert abs(l0 - l1) <= 1e-6
    assert g0.keys() == g1.keys() and len(g0) > 100
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=1e-6, msg=name)
    assert bn0.keys() == bn1.keys()
    for name in bn0:
        assert torch.equal(bn0[name], bn1[name]), name


def test_remat_step_matches_the_jax_remat_step():
    """The port's ``remat`` step against ``make_train_step(remat=True)`` of
    the JAX package (its optimizer the identity, so the parameters move by
    the gradients), on ``tests/test_torch_port_train.py``'s loss-graph case
    (tiny flagship, rates 0, BatchNorm batch statistics)."""
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu.train.loop import create_train_state, make_train_step
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict

    cfg, batch = _train_cfg(), _train_batch()
    jm = AVSRTask.build_model(cfg, TOKEN_LIST)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *batch))
    variables = _random_variables(shapes, seed=4)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), optax.identity())
    new, stats = make_train_step(jm, optax.identity(), donate=False, remat=True)(
        state, tuple(jnp.asarray(b) for b in batch), jax.random.PRNGKey(0))
    jgrads = jax.device_get(jax.tree_util.tree_map(lambda n, o: n - o, new.params, state.params))

    model = build_model(cfg, TOKEN_LIST, device="cpu")
    sd, dropped = convert_jax_variables(variables, model)
    assert dropped == []
    model.load_state_dict(sd, strict=True)
    loss, grads, bn = _port_step(model, tuple(torch.from_numpy(b) for b in batch), remat=True)
    np.testing.assert_allclose(loss, float(stats["loss"]), rtol=1e-4)
    for name, p in model.named_parameters():
        p.grad = grads[name]
    _check_grads(model, jgrads)
    want = export_torch_state_dict({"params": variables["params"],
                                    "batch_stats": jax.device_get(new.batch_stats)})
    for k, v in bn.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(), err_msg=k)


# ---------------------------------------------------------------- init

SCHEMES = ["xavier_uniform", "xavier_normal", "kaiming_uniform", "kaiming_normal"]


def _leaf_class(before, after) -> str:
    if np.array_equal(before, after):
        return "kept"
    if not np.any(after):
        return "zeros"
    if np.all(after == 1):
        return "ones"
    return "redrawn"


def _scheme_std_tree(params, scheme):
    """A tree of the params' shapes: each kernel of ndim >= 2 filled with
    the std ``scheme`` gives it by flax's fans (in_axis -2, out_axis -1,
    the rest the receptive field), every other leaf with 0."""
    from tailored_avsr_tpu_torch.utils.initialize import scheme_std

    def fill(path, x):
        shape = np.shape(x)
        if str(path[-1].key) != "kernel" or len(shape) < 2:
            return np.zeros(shape, np.float32)
        rf = int(np.prod(shape[:-2]))
        return np.full(shape, scheme_std(scheme, shape[-2] * rf, shape[-1] * rf), np.float32)
    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("scheme", SCHEMES + ["lecun_sideways"])
def test_init_scheme_matches_jax(scheme):
    """The same starting weights (the tiny flagship's, every leaf random)
    through the JAX ``initialize`` and the port's: each leaf by its key
    falls in the same class; every redrawn leaf of >= 4096 entries has a
    sample std within 10 % of the scheme's, in both; an unknown scheme
    raises ``ValueError`` in both."""
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu.utils.initialize import initialize as jinit
    from tailored_avsr_tpu_torch.tasks.avsr import build_model
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
    from tailored_avsr_tpu_torch.utils.initialize import initialize
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict

    cfg, batch = _train_cfg(), _train_batch()
    jm = AVSRTask.build_model(cfg, TOKEN_LIST)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *batch))
    variables = _random_variables(shapes, seed=4)
    model = build_model(cfg, TOKEN_LIST, device="cpu")
    model.load_state_dict(convert_jax_variables(variables, model)[0], strict=True)
    if scheme not in SCHEMES:
        with pytest.raises(ValueError):
            jinit(variables, scheme)
        with pytest.raises(ValueError):
            initialize(model, scheme, torch.Generator().manual_seed(0))
        return
    before = export_torch_state_dict(variables)
    after_j = export_torch_state_dict(jax.device_get(jinit(variables, scheme)))
    initialize(model, scheme, torch.Generator().manual_seed(0))
    after_p = {k: v.numpy() for k, v in model.state_dict().items()}
    std = export_torch_state_dict({"params": _scheme_std_tree(variables["params"], scheme)})
    classes, checked = {}, 0
    for k in before:
        cj, cp = _leaf_class(before[k], after_j[k]), _leaf_class(before[k], after_p[k])
        assert cj == cp, (k, cj, cp)
        classes[cj] = classes.get(cj, 0) + 1
        if cj == "redrawn" and before[k].size >= 4096:
            want = float(std[k].flat[0])
            for got in (after_j[k].std(), after_p[k].std()):
                assert abs(got / want - 1) <= 0.1, (k, got, want)
            checked += 1
    assert set(classes) == {"kept", "zeros", "ones", "redrawn"} and checked > 20, classes


# ---------------------------------------------------------------- scripts


def _script(name):
    """A JAX script of ``scripts/``, imported as its tests import it."""
    import importlib

    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The synthetic corpus, the tiny AVSR config, and two port checkpoints
    (seeds 1 and 2) with their JAX ``.ckpt`` twins (read by the JAX
    ``load_model`` from the port's ``.pth``)."""
    from tailored_avsr_tpu.tasks.avsr import AVSRTask
    from tailored_avsr_tpu.train.checkpoint import load_model, save_model as jsave
    from tailored_avsr_tpu_torch.tasks.common import build_model
    from tailored_avsr_tpu_torch.train.checkpoint import save_model
    from tailored_avsr_tpu_torch.utils.config import load_config
    from tests.synthetic import make_synthetic_corpus

    root = tmp_path_factory.mktemp("recipe")
    csv_path, token_path = make_synthetic_corpus(str(root / "corpus"), n=4)
    with open(os.path.join(ROOT, "configs/tests/avsr_tiny.yaml")) as f:
        c = yaml.safe_load(f)
    c["token_list"] = token_path
    cfg_path = str(root / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(c, f)
    cfg = load_config(cfg_path)
    tokens = [line.rstrip() for line in open(token_path) if line.rstrip()]
    jm = AVSRTask.build_model(cfg, tokens)
    frames = 8
    args = (np.zeros((1, frames * 640), np.float32), np.array([frames * 640], np.int32),
            np.zeros((1, frames, 88, 88), np.float32), np.array([frames], np.int32),
            np.ones((1, 3), np.int32), np.array([3], np.int32))
    template = _random_variables(jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)}, *args)))
    port, jax_dir = {}, root / "jax_exp" / "models"
    for epoch in (1, 2):
        model = build_model(cfg, tokens, generator=torch.Generator().manual_seed(epoch), device="cpu")
        path = str(root / "port_exp" / "models" / f"model_{epoch:03d}.pth")
        save_model(model, path)
        port[epoch] = path
        jsave(load_model(template, path), str(jax_dir / f"model_{epoch:03d}.ckpt"))
    return {"csv": csv_path, "cfg": cfg_path, "root": root, "port": port, "template": template}


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_study_adaptive_fusion_matches_the_jax_script(recipe, tmp_path, capsys):
    """``--mask audio`` on the synthetic split with one port checkpoint: the
    same sample ids, acoustic and visual weights within 1e-5, and the mean
    acoustic weight printed."""
    from tailored_avsr_tpu_torch import study_adaptive_fusion

    ckpt = recipe["port"][1]
    common = ["--config-file", recipe["cfg"], "--load-checkpoint", ckpt, "--dataset", recipe["csv"],
              "--mask", "audio"]
    _script("study_adaptive_fusion").main(common + ["--output-dir", str(tmp_path / "jax")])
    study_adaptive_fusion.main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "mean acoustic weight" in capsys.readouterr().out
    want, got = (_rows(str(tmp_path / d / "fusion_weights_audio.csv")) for d in ("jax", "port"))
    assert [r["sample_id"] for r in got] == [r["sample_id"] for r in want] and len(got) == 4
    for g, w in zip(got, want):
        for key in ("acoustic_weight", "visual_weight"):
            assert abs(float(g[key]) - float(w[key])) <= 1e-5, (g, w)


def test_get_val_accs_and_average_model_match_the_jax_scripts(recipe, tmp_path, monkeypatch):
    """``get_val_accs`` over both epochs' checkpoints (the port's ``.pth``,
    the JAX script's ``.ckpt`` twins): the same ``val_accs.csv`` epochs,
    WER and CER, best first, and ``.inf`` / ``.wer`` files an epoch. The
    JAX script writes each hypothesis as the repr of ``Speech2Text``'s
    (text, tokens, ids) tuple where the ``.inf`` protocol wants the text
    (ROADMAP.md section 3); here its engine returns the text, and it
    scores with its pure-Python bootstrap, which the port's ``evaluation``
    copies (the native scorer draws other resamples), so the two are
    scored alike. Then ``average_model --val-accs --top-k 2`` (and
    ``--exp-dir`` over a ``val_stats.csv``, and explicit paths) gives the
    JAX script's mean tensor for tensor."""
    import flax.serialization

    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch import average_model, get_val_accs
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict

    from tailored_avsr_tpu.evaluation import wer as jwer

    monkeypatch.setattr(JaxSpeech2Text, "__call__", lambda self, batch: [h[0][0] for h in self.nbest(batch)])
    monkeypatch.setattr(jwer, "_native", lambda: None)
    root = recipe["root"]
    want = _script("get_val_accs").main(["--config-file", recipe["cfg"], "--validation-dataset", recipe["csv"],
                                         "--exp-dir", str(root / "jax_exp"), "--output-dir", str(tmp_path / "jax")])
    get_val_accs.main(["--config-file", recipe["cfg"], "--validation-dataset", recipe["csv"],
                       "--exp-dir", str(root / "port_exp"), "--output-dir", str(tmp_path / "port"),
                       "--device", "cpu"])
    got = _rows(str(tmp_path / "port" / "val_accs.csv"))
    assert [(int(r["epoch"]), float(r["wer"]), float(r["cer"])) for r in got] == \
        [(r["epoch"], r["wer"], r["cer"]) for r in want]
    for e in (1, 2):
        assert os.path.exists(tmp_path / "port" / "inferences" / f"val_{e:03d}.inf")
        assert os.path.exists(tmp_path / "port" / "inferences" / f"val_{e:03d}.wer")

    out = str(tmp_path / "avg.pth")
    average_model.main(["--val-accs", str(tmp_path / "port" / "val_accs.csv"), "--top-k", "2", "--output", out])
    jout = str(tmp_path / "avg.ckpt")
    _script("average_model").main(["--val-accs", str(tmp_path / "jax" / "val_accs.csv"), "--top-k", "2",
                                   "--output", jout])
    with open(jout, "rb") as f:
        jtree = flax.serialization.msgpack_restore(f.read())
    jsd = export_torch_state_dict(jtree)
    sd = torch.load(out, weights_only=True)
    assert set(jsd) <= set(sd)
    for k, v in jsd.items():
        assert np.array_equal(sd[k].numpy(), np.asarray(v, sd[k].numpy().dtype)), k

    stats = root / "port_exp" / "val_stats.csv"
    stats.write_text("epoch,cer\n1,30.0\n2,20.0\n")
    top1 = str(tmp_path / "top1.pth")
    average_model.main(["--exp-dir", str(root / "port_exp"), "--top-k", "1", "--output", top1])
    explicit = str(tmp_path / "explicit.pth")
    average_model.main(["--checkpoints", recipe["port"][2], "--output", explicit])
    two = torch.load(recipe["port"][2], weights_only=True)
    for path in (top1, explicit):
        sd = torch.load(path, weights_only=True)
        assert all(torch.equal(sd[k], two[k]) for k in two)


def test_compute_flops_matches_the_jax_parameter_count(recipe, capsys):
    """The parameter count equals the JAX script's. The encode FLOPs differ
    by design: the port counts matmuls and convolutions over its plain path
    (``FlopCounterMode``: every kernel tap at every output position), XLA's
    cost analysis also counts the elementwise work but only the taps that
    fall inside a padded convolution's input. On the tiny model at 1 s x 2
    the visual frontend's padded 3x3 convolutions dominate: the port reads
    31.65 G against XLA's 26.98 G, a ratio of 1.173, held to 1.1-1.25."""
    from tailored_avsr_tpu_torch import compute_flops

    _script("compute_flops").main(["--config-file", recipe["cfg"], "--seconds", "1.0", "--batch-size", "2"])
    jout = capsys.readouterr().out
    got = compute_flops.main(["--config-file", recipe["cfg"], "--seconds", "1.0", "--batch-size", "2",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    jparams = float(jout.split("parameters: ")[1].split("M")[0])
    jflops = float(jout.split("): ")[1].split(" G")[0]) * 1e9
    assert f"parameters: {jparams:.2f}M" in out
    assert round(got["parameters"] / 1e6, 2) == jparams
    assert 1.1 <= got["flops"] / jflops <= 1.25, (got["flops"], jflops)
