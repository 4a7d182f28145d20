"""The port's n-gram fusion and weight-only quantisation against the JAX
package, in f32 on the CPU.

``parse_arpa`` and the dense table of ``NgramScorer`` equal the JAX ones;
its three scoring calls (the full scorer's step, the part scorer's
candidates, the time-sync beam's one candidate a row) give the same
numbers on the same buffers. ``quantize_model`` stores the payloads and
scales of ``quantize_variables`` bit for bit once the export's transpose
is applied, picks the same weights (``min_size`` scoping) and stores
``float16`` as bf16. Then ``Speech2Text.nbest`` of both engines on the same
weights with the n-gram (``full`` with and without the LM, ``part`` with
and without it, in the time-sync beam) and with quantised weights
(``qint8``, ``bfloat16``), and the CLI with ``--ngram-file``.

Tolerances: tables and payloads exact; beam scores within 1e-4, ids
identical.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_beam import LM_TINY, _engines, _same_nbest
from test_torch_port_slice import TOKENS

TOKEN_LIST = [line.rstrip() for line in open(TOKENS) if line.rstrip()]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test (the engine tests run the ResNet trunk)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _sentences(seed: int, n: int = 60):
    """Seeded 'sentences' of the Spanish letters, words joined by <space>."""
    rs = np.random.RandomState(seed)
    letters = TOKEN_LIST[3:-1]
    out = []
    for _ in range(n):
        words = [[letters[i] for i in rs.randint(0, 12, rs.randint(1, 6))] for _ in range(rs.randint(1, 4))]
        out.append([tok for j, w in enumerate(words) for tok in (["<space>"] if j else []) + w])
    return out


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    from tailored_avsr_tpu_torch.decode.ngram import write_arpa

    path = str(tmp_path_factory.mktemp("ngram") / "char3.arpa")
    write_arpa(path, _sentences(0))
    return path


def test_parse_arpa_and_table_match_jax(arpa):
    from tailored_avsr_tpu.decode.ngram import NgramScorer as J, parse_arpa as jparse
    from tailored_avsr_tpu_torch.decode.ngram import NgramScorer as P, parse_arpa as pparse

    assert pparse(arpa) == jparse(arpa)
    assert {n: len(t) for n, t in pparse(arpa).items()} == {1: 12 + 1, 2: len(pparse(arpa)[2]), 3: len(pparse(arpa)[3])}
    j, p = J(arpa, TOKEN_LIST), P(arpa, TOKEN_LIST)
    assert p.order == j.order == 3
    np.testing.assert_array_equal(p.table.numpy(), np.asarray(j.table))


def test_ngram_scoring_calls_match_jax(arpa):
    """``score_step`` and ``score_step_candidates`` on sos-prefixed buffers
    at every position (the first reads context token 0 where the buffer has
    none), ``score_candidates`` with per-row lengths including 0."""
    from tailored_avsr_tpu.decode.ngram import NgramScorer as J
    from tailored_avsr_tpu_torch.decode.ngram import NgramScorer as P

    j, p = J(arpa, TOKEN_LIST), P(arpa, TOKEN_LIST)
    rs = np.random.RandomState(1)
    v = len(TOKEN_LIST)
    ys = rs.randint(0, v, (6, 9)).astype(np.int32)
    ys[:, 0] = v - 1
    cand = rs.randint(0, v, (6, 5)).astype(np.int32)
    for pos in range(1, 9):
        np.testing.assert_array_equal(p.score_step(torch.from_numpy(ys).long(), pos).numpy(),
                                      np.asarray(j.score_step(jnp.asarray(ys), pos)))
        np.testing.assert_array_equal(
            p.score_step_candidates(torch.from_numpy(ys).long(), pos, torch.from_numpy(cand).long()).numpy(),
            np.asarray(j.score_step_candidates(jnp.asarray(ys), pos, jnp.asarray(cand))))
    lens = np.array([0, 1, 2, 5, 9, 3], np.int32)
    one = cand[:, 0]
    np.testing.assert_array_equal(
        p.score_candidates(torch.from_numpy(ys).long(), torch.from_numpy(lens), torch.from_numpy(one).long()).numpy(),
        np.asarray(j.score_candidates(jnp.asarray(ys), jnp.asarray(lens), jnp.asarray(one))))


# -------------------------------------------------------- quantisation


def _export(tree, params_root):
    """{flax path: array} -> {torch key: array in torch's layout}, by the
    port's key grammar (``torch_key_for``, ``_from_flax``)."""
    from tailored_avsr_tpu_torch.utils.torch_compat import _from_flax, torch_key_for

    out = {}
    for path, x in tree.items():
        segs = path.split("/")[1:]  # below "params"
        x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
        out[torch_key_for(segs, params_root)] = _from_flax(x, segs[-1])
    return out


@pytest.fixture(scope="module")
def weights():
    """The tiny flagship's and the tiny LM's JAX variables and port modules."""
    js, ps, _ = _engines("tiny", LM_TINY)
    return js.variables, {"params": js.lm_variables["params"]}, ps.model, ps.lm


@pytest.mark.parametrize("dtype,min_size", [("qint8", 4096), ("qint8", 256), ("float16", 4096), ("bfloat16", 1024)])
def test_quantize_matches_jax_bit_for_bit(dtype, min_size, weights):
    """The tiny flagship's and the tiny LM's weights: the same leaves
    picked (``min_size`` counts a flax leaf's elements), int8 payloads and
    per-output-channel scales identical after the export's transpose,
    ``float16`` stored as bf16; and every other parameter untouched."""
    from tailored_avsr_tpu.utils.quantize import quantize_variables
    from tailored_avsr_tpu_torch.utils.quantize import quantize_model, quantized_payloads

    model_vars, lm_vars, model, lm = weights
    model, lm = copy.deepcopy(model), copy.deepcopy(lm)
    for variables, module in ((model_vars, model), (lm_vars, lm)):
        before = {k: v.clone() for k, v in module.state_dict().items()}
        packed = quantize_variables(variables, dtype, min_size=min_size)["__quantized_leaves__"]
        want_q = _export(packed["q"], variables["params"])
        picked = quantize_model(module, dtype, min_size)
        got = quantized_payloads(module)
        prefix = "lm." if module is lm else ""
        assert {prefix + k for k in got} == set(want_q) and set(picked) == set(got)
        want_s = {k: np.asarray(jnp.broadcast_to(s, packed["q"][p].shape[-1:]).astype(jnp.float32))
                  for (p, s), k in zip(packed["scale"].items(), _export(packed["q"], variables["params"]))}
        for key, (payload, scale) in got.items():
            w_q = want_q[prefix + key]
            if dtype == "qint8":
                assert payload.dtype == torch.int8
                np.testing.assert_array_equal(payload.numpy(), w_q)
                np.testing.assert_array_equal(scale.float().numpy().reshape(-1), want_s[prefix + key].reshape(-1))
            else:
                assert payload.dtype == torch.bfloat16
                np.testing.assert_array_equal(payload.float().numpy(), w_q)
        for key, value in module.state_dict().items():
            if "parametrizations" not in key:
                np.testing.assert_array_equal(value.numpy(), before[key].numpy())


# ------------------------------------------------------ the whole engine


NGRAM_MODES = {
    "full_lm": (True, {"ngram_scorer": "full", "ngram_weight": 0.4, "lm_weight": 0.3}),
    "full_alone": (False, {"ngram_scorer": "full", "ngram_weight": 0.5}),
    "part_lm": (True, {"ngram_scorer": "part", "ngram_weight": 0.4, "lm_weight": 0.3}),
    "part_alone": (False, {"ngram_scorer": "part", "ngram_weight": 0.5}),
    "timesync": (True, {"decode_mode": "timesync", "ngram_weight": 0.5, "lm_weight": 0.3}),
    "full_lm_ctc_weight_1": (True, {"ctc_weight": 1.0, "ngram_weight": 0.4, "lm_weight": 0.3}),
}


@pytest.mark.parametrize("mode", list(NGRAM_MODES))
def test_speech2text_ngram_matches_jax(mode, arpa):
    """n-gram fusion through ``inference_conf ngram_file`` (the JAX engine
    given the path as its argument, which wins over the key): the full
    scorer folded into the LM and alone in its slot, the part scorer with
    and without the LM, the time-sync beam's in-loop n-gram, and the full
    scorer beside the full-prefix LM at ``ctc_weight: 1.0``."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text

    lm, conf = NGRAM_MODES[mode]
    js, ps, batch = _engines("tiny", LM_TINY if lm else None, beam_size=3, nbest=2, unroll=1, ngram_file=arpa,
                             **conf)
    assert ps.ngram is not None and js.ngram is not None
    np.testing.assert_array_equal(ps.ngram.table.numpy(), np.asarray(js.ngram.table))
    _same_nbest(ps.nbest(batch), js.nbest(batch))
    if mode == "full_alone":  # the constructor's path wins over the key
        cfg = copy.deepcopy(js.config)
        cfg.inference_conf = dict(cfg.inference_conf, ngram_file="/nonexistent.arpa")
        assert JaxSpeech2Text(cfg, ngram_path=arpa).ngram is not None
        from tailored_avsr_tpu_torch.inference import Speech2Text

        assert Speech2Text(cfg, ngram_path=arpa, device="cpu").ngram is not None


@pytest.mark.parametrize("dtype", ["qint8", "bfloat16"])
def test_speech2text_quantized_weights_match_jax(dtype):
    """``quantize_asr_model`` and ``quantize_lm`` (min size 256, so the
    tiny model's decoder, LM and encoder weights are picked): the port's
    weights stay quantised on the device, and ``nbest`` equals the JAX
    engine's on its quantised variables (one beam step a JAX loop body,
    ``unroll: 1``)."""
    from tailored_avsr_tpu.utils.quantize import quantize_variables

    conf = dict(beam_size=3, nbest=2, unroll=1, quantize_asr_model=True, quantize_lm=True, quantize_dtype=dtype,
                quantize_min_size=256)
    js, ps, batch = _engines("tiny", LM_TINY, **conf)
    # the JAX engine quantises in ensure_params, which the preset variables skip
    js.variables = quantize_variables(js.variables, dtype, min_size=256)
    js.lm_variables = quantize_variables(js.lm_variables, dtype, min_size=256)
    got = ps.nbest(batch)
    payloads = [p for name, p in ps.model.named_parameters() if "original0" in name]
    assert payloads and all(p.dtype == (torch.int8 if dtype == "qint8" else torch.bfloat16) for p in payloads)
    assert any("original0" in name for name, _ in ps.lm.named_parameters())
    _same_nbest(got, js.nbest(batch))


def test_cli_decodes_with_ngram_file(tmp_path, arpa):
    """``--ngram-file`` with ``ngram_weight`` > 0 in the config: the CLI
    trains the tiny model one epoch and decodes the test set through
    ``Speech2Text.stream`` with the n-gram, writing the .inf and .wer."""
    import yaml

    from tailored_avsr_tpu_torch import avsr_main
    from tests.synthetic import make_synthetic_corpus

    csv_path, token_path = make_synthetic_corpus(str(tmp_path / "corpus"), n=3)
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs/tests/avsr_tiny.yaml")) as f:
        c = yaml.safe_load(f)
    c["token_list"] = token_path
    c["training_settings"].update(epochs=1, average_epochs=1, batch_size=3)
    c["inference_conf"].update(ngram_weight=0.5, ngram_scorer="part")
    cfg = str(tmp_path / "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(c, f)
    out = str(tmp_path / "exp")
    args = ["--config-file", cfg, "--training-dataset", csv_path, "--validation-dataset", csv_path,
            "--test-dataset", csv_path, "--output-dir", out, "--output-name", "t", "--device", "cpu"]
    avsr_main.main(args + ["--mode", "both", "--ngram-file", arpa])
    with open(os.path.join(out, "inference", "t.inf")) as f:
        assert len(f.read().splitlines()) == 3
    assert os.path.exists(os.path.join(out, "inference", "t.wer"))
    with pytest.raises(FileNotFoundError):  # the file is read: a missing one fails loudly
        avsr_main.main(args + ["--mode", "inference", "--ngram-file", str(tmp_path / "missing.arpa"),
                               "--load-checkpoint", os.path.join(out, "models", "model_average.pth")])
