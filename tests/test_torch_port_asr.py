"""The port's ASR / VSR / conventional builders, refusals, checkpoints, CLI
and ``study_branches`` against the JAX package, on the CPU.

- Every config under ``configs/ASR``, ``configs/VSR`` and ``configs/AVSR``
  (the Mask-CTC and transducer ones among them) builds at full width on
  the meta device, with the parameter names and shapes of the JAX model's
  export (``jax.eval_shape`` of its init); choices the port does not build
  raise naming their ``ROADMAP.md`` item.
- A port checkpoint of each family (Mask-CTC and the transducer's packed
  LSTM among them) loads into the JAX ``load_model`` with every array
  equal, and the port's export equals the JAX export.
- The training CLI trains and decodes tiny ASR, VSR, Mask-CTC AVSR and
  transducer ASR models on the synthetic corpus.
- ``study_branches``' per-layer means equal, within 1e-5, those of the JAX
  model's ``branch_weights`` on the same batches and weights.
"""

import csv
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from tailored_avsr_tpu.utils.config import load_config
from tailored_avsr_tpu.utils.torch_compat import export_torch_state_dict
from tailored_avsr_tpu_torch.tasks import common
from test_torch_port_branchformer import ASR, CONVENTIONAL, TOKEN_LIST, VSR, speech_batch, tiny_cfg
from test_torch_port_slice import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(p for d in ("ASR", "VSR", "AVSR") for p in glob.glob(os.path.join(ROOT, "configs", d, "*.yaml")))
MASKCTC = "configs/AVSR/tailored_maskctc_spanish.yaml"
FLAGSHIP = "configs/AVSR/tailored_transformer+ctc_spanish.yaml"
TRANSDUCER = "configs/ASR/branchformer_transducer_spanish.yaml"
FAMILIES = [ASR, VSR, CONVENTIONAL, MASKCTC, TRANSDUCER]
FAMILY_IDS = ["asr", "vsr", "conventional", "maskctc", "transducer"]
# the encoder trees of item 8.2 and the decoder and RNN-encoder trees of
# items 8.3 and 8.5 (``PORTED_CHOICES`` keys), exported beside the families'
ENCODER_TREES = ["conformer", "e_branchformer", "interctc", "conventional_conformer", "conventional_interctc",
                 "tailored_zero_triu", "sim_t", "sim_t_mlm", "lightweight_conv", "dynamic_conv",
                 "lightweight_conv2d", "dynamic_conv2d", "rnn_decoder", "s4", "rnn_encoder", "vgg_rnn"]


def _tiny(path):
    """``tiny_cfg`` of a family; the tailored encoder's per-layer branch
    masks cut to its two blocks."""
    if path in (MASKCTC, FLAGSHIP):
        return tiny_cfg(path, acoustic_use_attn=[False, True], visual_use_attn=[True, False])
    return tiny_cfg(path)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tokens(cfg):
    path = os.path.join(ROOT, cfg.token_list)
    return [line.rstrip() for line in open(path) if line.rstrip()]


def _jax_model(cfg, tokens):
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu.tasks.avsr import AVSRTask

    return (AVSRTask if cfg.task == "avsr" else ASRTask).build_model(cfg, list(tokens))


def _jax_shapes(jm, task):
    """The JAX variables' shapes, from an init traced on a 4-frame batch (a
    PIT model's targets one row per reference speaker)."""
    audio = (np.zeros((1, 2560), np.float32), np.array([2560], np.int32))
    video = (np.zeros((1, 4, 88, 88), np.float32), np.array([4], np.int32))
    args = {"avsr": audio + video, "asr": audio, "vsr": video}[task]
    refs = getattr(jm, "num_ref", None)
    text = (np.ones((1, 3), np.int32), np.array([3], np.int32)) if refs is None else (
        np.ones((1, refs, 3), np.int32), np.full((1, refs), 3, np.int32))
    args = [jax.numpy.asarray(a) for a in args]  # device arrays: numpy ones cannot take a traced index
    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                          *args, *text))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_builds_with_the_jax_parameter_names(path):
    """Full width, on the meta device: the port's state dict has the JAX
    export's keys and shapes: every config of the repository builds."""
    cfg = load_config(path)
    tokens = _tokens(cfg)
    task = "avsr" if cfg.task == "avsr" else "asr"
    port = __import__(f"tailored_avsr_tpu_torch.tasks.{task}", fromlist=["build_meta"]).build_meta(cfg, tokens)
    shapes = _jax_shapes(_jax_model(cfg, tokens), cfg.task)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = {k: v.shape for k, v in export_torch_state_dict(zeros).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got == want
    assert type(port.encoder).__name__ == {"branchformer": "BranchformerEncoder", "tailored": "TailoredEncoder",
                                           "conventional": "ConventionalEncoder"}[cfg.encoder]
    assert type(port).__name__.endswith("MaskCTCModel") == (cfg.model == "maskctc")
    assert (port.joint_network is not None) == (cfg.decoder == "transducer")


def _set(cfg, section, value):
    """``value`` into ``cfg``: several top-level keys (``section`` None), a
    section's keys (a dict) or one top-level key."""
    if section is None:
        for key, v in value.items():
            setattr(cfg, key, v)
    else:
        if isinstance(value, dict):
            value = dict(getattr(cfg, section), **value)
        setattr(cfg, section, value)
    return cfg


_ABS = dict(tiny_cfg(ASR).encoder_conf, attention_layer_type="selfattn", pos_enc_layer_type="abs_pos")
_FUSED = {"frontends": [{"frontend_type": "default", "n_mels": 24, "hop_length": 160},
                        {"frontend_type": "sliding_window", "win_length": 400, "hop_length": 80}],
          "proj_dim": 20}
PORTED_CHOICES = {
    "e_branchformer": (ASR, "encoder", "e_branchformer"),
    "conformer": (ASR, None, {"encoder": "conformer", "encoder_conf": dict(
        tiny_cfg(ASR).encoder_conf, cnn_module_kernel=5)}),
    "merge_conv_kernel": (ASR, "encoder_conf", {"merge_method": "concat", "merge_conv_kernel": 3}),
    "zero_triu": (ASR, "encoder_conf", {"zero_triu": True}),
    "interctc": (ASR, "encoder_conf", {"interctc_layer_idx": [1], "interctc_use_conditioning": True}),
    "conv1d2": (ASR, "encoder_conf", {"input_layer": "conv1d2"}),
    "legacy": (ASR, "encoder_conf", {"rel_pos_type": "legacy"}),
    "selfattn_abs_pos": (ASR, "encoder_conf", {"attention_layer_type": "selfattn", "pos_enc_layer_type": "abs_pos"}),
    "conventional_conformer": (CONVENTIONAL, "encoder_conf", {"encoder_class_type": "conformer",
                                                              "cnn_module_kernel": 5}),
    "conventional_interctc": (CONVENTIONAL, "encoder_conf", {
        "interctc_layer_idx": [2], "interctc_use_conditioning": True, "audiovisual_interctc_conditioning": True}),
    "tailored_zero_triu": (MASKCTC, "encoder_conf", {"zero_triu": True}),
    # items 8.3 and 8.5 at the configs' full widths (``FULL``): the decoders
    # from the ASR / VSR / flagship YAMLs' decoder_conf (the keys a decoder
    # does not take dropped, as in JAX), the RNN encoders at the registry's
    # defaults but the YAML's output_size
    "sim_t": (FLAGSHIP, "decoder", "sim_t"),
    "sim_t_mlm": (ASR, None, {"model": "maskctc", "decoder": "sim_t"}),
    "lightweight_conv": (ASR, "decoder", "lightweight_conv"),
    "dynamic_conv": (ASR, "decoder", "dynamic_conv"),
    "lightweight_conv2d": (ASR, None, {"decoder": "lightweight_conv2d", "decoder_conf": {
        "num_blocks": 3, "conv_kernel_length": [3, 5, 7], "conv_usebias": True, "conv_wshare": 8}}),
    "dynamic_conv2d": (ASR, None, {"decoder": "dynamic_conv2d", "decoder_conf": {
        "num_blocks": 2, "conv_kernel_length": 5, "conv_usebias": True}}),
    "no_output_layer": (FLAGSHIP, "decoder_conf", {"use_output_layer": False}),
    "lightconv_variant": (FLAGSHIP, "decoder_conf", {"layer_variant": "lightconv"}),
    "rnn_decoder": (ASR, "decoder", "rnn"),
    "vsr_rnn_decoder": (VSR, "decoder", "rnn"),
    "s4": (ASR, "decoder", "s4"),
    "rnn_encoder": (ASR, "encoder", "rnn"),
    "vgg_rnn": (ASR, "encoder", "vgg_rnn"),
    "rnn_encoder_unprojected": (ASR, None, {"encoder": "rnn", "encoder_conf": {
        "num_layers": 3, "bidirectional": False, "use_projection": False, "output_size": 96}}),
    # items 8.4 and 8.6: the streaming encoders, the rest of the input side, PIT
    "pit_espnet": (ASR, None, {"model": "pit_espnet", "encoder": "transformer_multispkr", "encoder_conf": _ABS}),
    "transformer_multispkr": (ASR, None, {
        "model": "pit_espnet", "encoder": "transformer_multispkr", "encoder_conf": dict(
            _ABS, num_blocks_sd=1, num_inf=3), "model_conf": {"num_inf": 3, "num_ref": 3, "ctc_weight": 1.0}}),
    "contextual_block_transformer": (ASR, None, {"encoder": "contextual_block_transformer", "encoder_conf": dict(
        _ABS, block_size=6, hop_size=2, look_ahead=2)}),
    "contextual_block_conformer": (ASR, None, {"encoder": "contextual_block_conformer", "encoder_conf": dict(
        _ABS, block_size=6, hop_size=2, cnn_module_kernel=5)}),
    "sliding_window": (ASR, None, {"frontend": "sliding_window", "frontend_conf": {"win_length": 320}}),
    "fused": (ASR, None, {"frontend": "fused", "frontend_conf": _FUSED}),
    "global_mvn": (ASR, "normalize", "global_mvn"),
    "preencoder": (ASR, None, {"preencoder": "linear", "preencoder_conf": {"output_size": 40}}),
    "conventional_postencoder": (CONVENTIONAL, None, {"postencoder": "linear",
                                                      "postencoder_conf": {"output_size": 48}}),
    # item 9: the lip frontend's cross-replica BatchNorm (trained and served
    # by tests/test_torch_port_parallel.py)
    "vsr_bn_axis_name": (VSR, "frontend_conf", {"bn_axis_name": "batch"}),
    "conventional_bn_axis_name": (CONVENTIONAL, "visual_frontend_conf", {"bn_axis_name": "batch"}),
}
FULL = {"sim_t", "sim_t_mlm", "lightweight_conv", "dynamic_conv", "lightweight_conv2d", "dynamic_conv2d",
        "no_output_layer", "lightconv_variant", "rnn_decoder", "vsr_rnn_decoder", "s4", "rnn_encoder", "vgg_rnn",
        "rnn_encoder_unprojected"}


def _choice_cfg(case, full: bool):
    """The config of a ``PORTED_CHOICES`` case: the repo's YAML (``full``) or
    its tiny cut, the case's keys set."""
    path, section, value = PORTED_CHOICES[case]
    if full:
        cfg = load_config(os.path.join(ROOT, path))
    else:
        cfg = _tiny(path)
    if section == "encoder" and value in ("rnn", "vgg_rnn"):
        # the registry's defaults but the width: the YAML's Branchformer keys are dropped
        cfg.encoder_conf = {"output_size": cfg.encoder_conf["output_size"]} if full else {
            "output_size": 48, "hidden_size": 24, "num_layers": 2}
    return _set(cfg, section, value)


@pytest.mark.parametrize("case", sorted(PORTED_CHOICES))
def test_ported_choices_build_with_the_jax_parameter_names(case):
    """Each choice this file's refusal list once held, built on the meta
    device (items 8.3 and 8.5 at full width): the state dict's keys and
    shapes are the JAX export's, a global MVN's ``stats`` collection with
    them (the port's export carries it; the JAX export drops it)."""
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict as port_export

    cfg = _choice_cfg(case, case in FULL)
    task = "avsr" if cfg.task == "avsr" else "asr"
    port = __import__(f"tailored_avsr_tpu_torch.tasks.{task}", fromlist=["build_meta"]).build_meta(cfg, TOKEN_LIST)
    shapes = _jax_shapes(_jax_model(cfg, TOKEN_LIST), cfg.task)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = {k: v.shape for k, v in port_export(zeros).items()}
    jax_keys = {k: v.shape for k, v in export_torch_state_dict(zeros).items()}
    stats = sorted(set(want) - set(jax_keys))  # only the stats collection's keys are the port's own
    assert {k: v for k, v in want.items() if k not in stats} == jax_keys
    assert stats == (["normalize.mean", "normalize.std"] if "stats" in zeros else [])
    got = {k: tuple(v.shape) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got == want


def test_mismatched_attention_and_positional_encoding_raise_as_in_jax():
    """The JAX encoder's pairing check (rel-pos attention needs the rel-pos
    table): ValueError in both packages, before any refusal."""
    cfg = tiny_cfg(ASR, pos_enc_layer_type="abs_pos")
    with pytest.raises(ValueError, match="requires pos_enc_layer_type"):
        common.build_model(cfg, TOKEN_LIST, device="cpu")
    with pytest.raises(ValueError, match="requires pos_enc_layer_type"):
        _jax_shapes(_jax_model(cfg, TOKEN_LIST), "asr")


def test_constructor_tables_cover_the_jax_fields():
    """Each key the JAX encoders take (Branchformer, Conformer, Transformer,
    Longformer, tailored, conventional, and their layers' attention and
    position modules' settings among them) is a port constructor argument:
    no encoder key is refused or dropped any more."""
    from tailored_avsr_tpu.models import conformer as jconf
    from tailored_avsr_tpu.models import transformer_encoder as jte
    from tailored_avsr_tpu.models.branchformer import BranchformerEncoder as JB
    from tailored_avsr_tpu.models.conventional import ConventionalEncoder as JC
    from tailored_avsr_tpu.models.tailored import TailoredEncoder as JT
    from tailored_avsr_tpu_torch.models import conformer as pconf
    from tailored_avsr_tpu_torch.models import transformer_encoder as pte
    from tailored_avsr_tpu_torch.models.branchformer import BranchformerEncoder
    from tailored_avsr_tpu_torch.models.conventional import ConventionalEncoder
    from tailored_avsr_tpu_torch.models.tailored import TailoredEncoder

    pairs = ((JB, BranchformerEncoder), (JC, ConventionalEncoder), (JT, TailoredEncoder),
             (jconf.ConformerEncoder, pconf.ConformerEncoder), (jte.TransformerEncoder, pte.TransformerEncoder),
             (jte.LongformerEncoder, pte.LongformerEncoder))
    for jcls, pcls in pairs:
        jfields = {f.name for f in dataclasses.fields(jcls)} - {"parent", "name"}
        pnames = common.constructor_names(pcls)
        assert jfields <= pnames, (jcls.__name__, sorted(jfields - pnames))
    assert common.constructor_names(pconf.ConformerEncoder) == common.constructor_names(BranchformerEncoder) | {
        "cnn_module_kernel"}


def test_build_model_picks_the_task_and_needs_the_card(monkeypatch):
    """``tasks.common.build_model`` builds the task's model; without
    ``device=`` it needs the card, as every builder of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.build_model(tiny_cfg(ASR), TOKEN_LIST)
    kinds = {p: type(common.build_model(tiny_cfg(p), TOKEN_LIST, device="cpu")).__name__
             for p in (ASR, VSR, CONVENTIONAL)}
    assert list(kinds.values()) == ["ASRModel", "ASRModel", "AVSRModel"]
    cfg = tiny_cfg(ASR)
    cfg.task = "lm"
    with pytest.raises(ValueError, match="unknown task"):
        common.build_model(cfg, TOKEN_LIST, device="cpu")


@pytest.mark.parametrize("path", FAMILIES, ids=FAMILY_IDS)
def test_port_checkpoint_loads_into_the_jax_package(path, tmp_path):
    """A port ``.pth`` (BatchNorm statistics moved by a train-mode forward)
    read by the JAX ``load_model`` gives every array exactly."""
    from tailored_avsr_tpu.train.checkpoint import load_model as jax_load_model
    from tailored_avsr_tpu_torch.train.checkpoint import save_model

    cfg = _tiny(path)
    model = common.build_model(cfg, TOKEN_LIST, generator=torch.Generator().manual_seed(3), device="cpu")
    if cfg.task == "vsr":
        b = speech_batch("vsr")
        model.train()(*(torch.from_numpy(b[k]) for k in ("speech", "speech_lengths", "text", "text_lengths")))
    save = str(tmp_path / "port.pth")
    save_model(model, save)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      _jax_shapes(_jax_model(cfg, TOKEN_LIST), cfg.task))
    loaded = export_torch_state_dict(jax_load_model(template, save))
    state = model.state_dict()
    assert set(loaded) == {k for k in state if not k.endswith("num_batches_tracked")}
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, state[k].numpy(), err_msg=k)


@pytest.mark.parametrize("path", FAMILIES + ENCODER_TREES, ids=FAMILY_IDS + ENCODER_TREES)
def test_port_export_equals_the_jax_export(path):
    """The port's numpy-only copy of ``export_torch_state_dict`` against the
    JAX package's on each family's tree (the conventional stacks' keys
    among them) and the new encoders' (the Conformer conv module and its
    BatchNorm statistics, the E-Branchformer fusion conv, the conditioning
    layers): the same keys, and each array equal with its dtype."""
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict as pexport

    if path in PORTED_CHOICES:
        cfg = _choice_cfg(path, False)
    else:
        cfg = _tiny(path)
    shapes = _jax_shapes(_jax_model(cfg, TOKEN_LIST), cfg.task)
    variables = _random_variables(shapes, seed=6)
    want, got = export_torch_state_dict(variables), pexport(variables)
    assert list(got) == list(want) and len(got) > 50
    assert any(".encoders.1." in k or ".decoders.1." in k or "_1." in k for k in got)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


# ---------------------------------------------------------------- CLI and study_branches


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")), n=3, nframes=10)


def _cli_config(tmp_path, path, token_path, **encoder):
    """A repo config cut to 32-d, 2 + 1 blocks, one epoch, beam 2."""
    with open(path) as f:
        c = yaml.safe_load(f)
    c["token_list"] = token_path
    c["encoder_conf"].update(output_size=32, linear_units=48, cgmlp_linear_units=48, cgmlp_conv_kernel=7,
                             num_blocks=2, **encoder)
    if c.get("decoder") == "transducer":
        c["decoder_conf"].update(embed_size=24, hidden_size=32)
        c["joint_net_conf"].update(joint_space_size=40)
    else:
        c["decoder_conf"].update(linear_units=48, num_blocks=1)
    c["inference_conf"].update(beam_size=2, batch_size=2)
    c["training_settings"].update(batch_size=3, epochs=1, average_epochs=1, accum_grad=1, warmup_steps=10,
                                  num_workers=0)
    out = str(tmp_path / os.path.basename(path))
    with open(out, "w") as f:
        yaml.safe_dump(c, f)
    return out


@pytest.mark.parametrize("path", [ASR, VSR, MASKCTC, TRANSDUCER], ids=["asr", "vsr", "maskctc", "transducer"])
def test_cli_trains_and_decodes(corpus, tmp_path, path):
    """``--mode both``: one epoch, the averaged checkpoint, then decoding
    (Mask-CTC and the transducer's beam 2 through ``nbest``)."""
    from tailored_avsr_tpu_torch import avsr_main

    csv_path, token_path = corpus
    encoder = dict(acoustic_use_attn=[False, True], visual_use_attn=[True, False]) if path == MASKCTC else {}
    cfg = _cli_config(tmp_path, path, token_path, **encoder)
    out = str(tmp_path / "exp")
    avsr_main.main(["--config-file", cfg, "--training-dataset", csv_path, "--validation-dataset", csv_path,
                    "--test-dataset", csv_path, "--mode", "both", "--output-dir", out, "--output-name", "t",
                    "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(out, "models"))) == ["model_001.pth", "model_average.pth",
                                                               "train_state.pt"]
    with open(os.path.join(out, "inference", "t.inf")) as f:
        assert len(f.readlines()) == 3
    with open(os.path.join(out, "inference", "t.wer")) as f:
        assert f.readline().startswith("WER: ")


def test_study_branches_matches_the_jax_branch_weights(corpus, tmp_path):
    """The CSV of a port checkpoint: per-layer means within 1e-5 of the JAX
    model's ``branch_weights`` on the same weights and batches, std and
    ``use_attn`` as the JAX script computes them; an encoder without a
    ``learned_ave`` layer exits with the JAX script's message."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tailored_avsr_tpu_torch import study_branches
    from tailored_avsr_tpu_torch.data.dataloader import AVSRDataLoader
    from tailored_avsr_tpu_torch.data.dataset import AVSRDataset
    from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
    from tailored_avsr_tpu_torch.tasks.asr import build_model
    from tailored_avsr_tpu_torch.train.checkpoint import save_model
    from tailored_avsr_tpu_torch.utils.config import load_config as port_load_config
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

    csv_path, token_path = corpus
    cfg_path = _cli_config(tmp_path, ASR, token_path, dropout_rate=0.0)
    cfg = port_load_config(cfg_path)
    tokenizer, converter = get_tokenizer_converter(cfg)
    batches = list(AVSRDataLoader(AVSRDataset(csv_path, task="asr", is_training=False), 4, task="asr",
                                  tokenizer=tokenizer, converter=converter, is_training=False))
    jm = ASRTask.build_model(load_config(cfg_path), list(converter.token_list))
    args = [batches[0][k] for k in ("speech", "speech_lengths", "text", "text_lengths")]
    variables = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args)), seed=8)
    forward = jax.jit(lambda v, *a: jm.apply(v, *a)[1]["branch_weights"])
    want = {}
    for batch in batches:
        for layer, aux in forward(variables, *(batch[k] for k in ("speech", "speech_lengths", "text",
                                                                  "text_lengths"))):
            want.setdefault(int(layer), []).append(np.asarray(aux["weight_global"]))
    model = build_model(cfg, converter.token_list, device="cpu")
    model.load_state_dict(convert_jax_variables(variables, model)[0], strict=True)
    ckpt = str(tmp_path / "asr.pth")
    save_model(model, ckpt)
    out = str(tmp_path / "scores")
    study_branches.main(["--config-file", cfg_path, "--load-checkpoint", ckpt, "--dataset", csv_path,
                         "--output-dir", out, "--device", "cpu"])
    with open(os.path.join(out, "branch_scores.csv")) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["layer", "mean_attn_weight", "std_attn_weight", "use_attn"]
    assert [int(r["layer"]) for r in rows] == sorted(want) == [1, 2]
    for r in rows:
        w = np.concatenate(want[int(r["layer"])])
        assert w.shape == (3,)
        np.testing.assert_allclose(float(r["mean_attn_weight"]), w.mean(), atol=1e-5)
        np.testing.assert_allclose(float(r["std_attn_weight"]), w.std(), atol=1e-5)
        assert r["use_attn"] == str(bool(w.mean() > 0.5))

    concat = _cli_config(tmp_path, ASR, token_path, merge_method="concat")
    with pytest.raises(SystemExit, match="no learned_ave branch weights found"):
        study_branches.main(["--config-file", concat, "--dataset", csv_path, "--output-dir", out,
                             "--device", "cpu"])
