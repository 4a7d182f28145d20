"""The PyTorch port's serving slice as a whole against the JAX package:
log-mel -> MVN -> conv2d subsampling | Conv3D-ResNet18 -> align -> rel-pos
-> tailored encoder -> adaptive fusion -> CTC -> greedy, and
``Speech2Text.greedy``, at the tiny flagship and at full width (12 blocks,
256-d) with 8 frames and batch 2, in f32 on the CPU.

Weights: every leaf of the JAX tree is drawn from ``np.random.RandomState``
at its initialisation scale, with non-zero biases and BN statistics (what
``tests/test_torch_flagship.py`` gets by perturbing an init, without the
cost of a JAX init of the whole model), and reaches the port through
``utils/convert.py`` with a strict load.

Tolerances: encoder output 1e-4 abs on frames where both streams are valid
(f32 rounding through the frontends and the layers). On frames where the
audio buffer is padding but the video is valid, 2e-3: the padded rows are
-1 * sqrt(d) plus the modality embedding, nearly constant across channels,
and flax's LayerNorm takes the variance as E[x^2] - E[x]^2, which cancels
there; the port's two-pass LayerNorm agrees with an f64 run to 1e-5 on
those rows. CTC log-probs 1e-3. Greedy ids and transcripts must be equal.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tailored_avsr_tpu.ops.subsampling import subsampled_length
from tailored_avsr_tpu.tasks.avsr import AVSRTask
from tailored_avsr_tpu_torch.ops import attention as port_attention
from tailored_avsr_tpu_torch.tasks.avsr import build_model
from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = os.path.join(ROOT, "tokenizers/char/spanish.txt")


def _random_variables(shapes, seed=0):
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1].key)
        shape = s.shape
        if name == "kernel":
            x = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.05 * rs.randn(*shape)
        elif name == "var":
            x = 1.0 + 0.3 * np.abs(rs.randn(*shape))
        elif name.startswith("pos_bias") or name == "embedding":
            x = 0.3 * rs.randn(*shape)
        else:  # biases, BN means
            x = 0.05 * rs.randn(*shape)
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(b=2, frames=8):
    rs = np.random.RandomState(0)
    samples = frames * 640
    return {
        "audio": (rs.randn(b, samples) * 0.1).astype(np.float32),
        "audio_lengths": np.array([samples, samples - 640], np.int32),
        "video": rs.randn(b, frames, 88, 88).astype(np.float32),
        "video_lengths": np.array([frames, frames - 1], np.int32),
    }


@pytest.fixture(scope="module", params=["tiny", "full"])
def flagship(request):
    cfg = graft._flagship_cfg(tiny=request.param == "tiny")
    cfg.token_list = TOKENS
    token_list = [line.rstrip() for line in open(TOKENS) if line.rstrip()]
    jm = AVSRTask.build_model(cfg, token_list)
    batch = _batch()
    args = tuple(batch[k] for k in ("audio", "audio_lengths", "video", "video_lengths"))
    text = np.ones((2, 4), np.int32)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                        *args, text, np.full((2,), 4, np.int32)))
    variables = _random_variables(shapes)

    @jax.jit
    def serve(v, *a):
        enc, lens, _ = jm.apply(v, *a, method="encode")
        logp = jm.apply(v, enc, method=lambda m, x: m.ctc.log_softmax(x))
        ids = jm.apply(v, enc, method=lambda m, x: m.ctc.argmax(x))
        return enc, lens, logp, ids

    want = [np.asarray(x) for x in serve(variables, *args)]
    return {"cfg": cfg, "tokens": token_list, "jax_model": jm, "variables": variables,
            "batch": batch, "args": args, "want": want}


def _port(flagship, route="eager", monkeypatch=None):
    cfg = copy.deepcopy(flagship["cfg"])
    if route != "eager":
        cfg.encoder_conf = dict(cfg.encoder_conf, use_flash=True, use_fused_csgu=True)
    if route == "k1":
        monkeypatch.setattr(port_attention, "FLASH_RELPOS_MIN_BIAS_BYTES", 0)
    model = build_model(cfg, flagship["tokens"], device="cpu")
    sd, dropped = convert_jax_variables(flagship["variables"], model)
    model.load_state_dict(sd, strict=True)
    return model, dropped


def test_convert_names_dropped_prefixes(flagship):
    """Every exported key, the attention decoder's included, has a module."""
    _, dropped = _port(flagship)
    assert dropped == []


def test_encode_matches_jax(flagship):
    model, _ = _port(flagship)
    enc, lens, logp, _ = flagship["want"]
    with torch.no_grad():
        got, got_lens, _ = model.encode(*(torch.from_numpy(a) for a in flagship["args"]))
        got_logp = model.ctc.log_softmax(got)
    np.testing.assert_array_equal(got_lens.numpy(), lens)
    b = flagship["batch"]
    t = enc.shape[1]
    a_len = subsampled_length(b["audio_lengths"] // 160 + 1, 4)
    frames = np.arange(t)[None, :]
    a_valid, v_valid = frames < a_len[:, None], frames < b["video_lengths"][:, None]
    both, one = a_valid & v_valid, a_valid ^ v_valid
    assert one.any()  # the audio buffer is one frame short of the video's
    np.testing.assert_allclose(got.numpy()[both], enc[both], atol=1e-4)
    np.testing.assert_allclose(got.numpy()[one], enc[one], atol=2e-3)
    valid = frames < lens[:, None]
    np.testing.assert_allclose(got_logp.numpy()[valid], logp[valid], atol=1e-3)


@pytest.mark.parametrize("route", ["eager", "k2", "k1"])
def test_greedy_ids_match_jax(flagship, route, monkeypatch):
    """Eager route, and the kernel routes (use_flash + use_fused_csgu: the
    kernels' plain versions on the CPU) with the streamed bias (k2) or the
    in-kernel rel-pos term (k1)."""
    model, _ = _port(flagship, route, monkeypatch)
    _, lens, _, ids = flagship["want"]
    with torch.no_grad():
        got, got_lens = model.ctc_greedy(*(torch.from_numpy(a) for a in flagship["args"]))
    np.testing.assert_array_equal(got_lens.numpy(), lens)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(got.numpy()[i, :n], ids[i, :n])


def test_speech2text_greedy_matches_jax(flagship):
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    js = JaxSpeech2Text(flagship["cfg"])
    js.variables = jax.tree_util.tree_map(jnp.asarray, flagship["variables"])
    want = js.greedy(flagship["batch"])

    ps = Speech2Text(flagship["cfg"], device="cpu")
    sd, _ = convert_jax_variables(flagship["variables"], ps.model)
    ps.model.load_state_dict(sd, strict=True)
    got = ps.greedy(flagship["batch"])
    assert got == want
    assert any(got)  # the comparison is not between empty transcripts


def test_inputs_dequantize_like_jax():
    """uint8 video / int16 audio are dequantised on the device as the JAX
    engine does, with -1 past each utterance's length."""
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text
    from tailored_avsr_tpu_torch.inference import Speech2Text

    cfg = graft._flagship_cfg(tiny=True)
    cfg.token_list = TOKENS
    rs = np.random.RandomState(5)
    args = (
        rs.randint(-32768, 32767, (2, 3200)).astype(np.int16), np.array([3200, 2000], np.int32),
        rs.randint(0, 256, (2, 5, 88, 88)).astype(np.uint8), np.array([5, 3], np.int32),
    )
    want = JaxSpeech2Text(cfg)._dequantize(tuple(jnp.asarray(a) for a in args))
    got = Speech2Text(cfg, device="cpu").inputs(dict(zip(
        ("audio", "audio_lengths", "video", "video_lengths"), args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
