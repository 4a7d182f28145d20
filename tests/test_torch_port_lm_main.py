"""The port's LM trainer (``tailored_avsr_tpu_torch/lm_main.py``) against the
root ``lm_main.py`` of the JAX package, in f32 on the CPU: the dataset in
its two modes, the batches, three train steps of a tiny LM (2 layers, 64
units) from the same weights, and the CLI end to end.

Tolerances: ids and batches equal; per-step loss within 1e-5 and every
parameter after three Adam + Noam steps within 1e-4 (absolute, on O(1)
weights: f32 sums in another order, through Adam's normalised update);
the averaged checkpoint's NLL through the JAX ``load_model`` within 1e-5
of the port's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = os.path.join(ROOT, "tokenizers/char/spanish.txt")
LM_CONF = dict(pos_enc=None, embed_unit=32, att_unit=64, head=4, unit=64, layer=2, dropout_rate=0.0)
TRAINING = dict(optimizer="adam", scheduler="noam", batch_size=4, warmup_steps=10, learning_rate=0.001,
                noam_factor=1.0, grad_clip=-1.0, accum_grad=1, epochs=2, average_epochs=2)
SENTENCES = ["hola que tal", "el perro {come} pan", "", "  la casa es grande  ", "buenos dias a todos",
             "una frase un poco mas larga que las otras", "si", "tres tristes tigres", "el gato duerme",
             "mañana será otro día"]


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    """A text file of sentences (with braces, padding spaces and an empty
    line) and a config of the tiny LM over the Spanish character list."""
    root = tmp_path_factory.mktemp("lm")
    path = root / "text.txt"
    path.write_text("\n".join(SENTENCES) + "\n", encoding="utf-8")
    cfg = root / "lm.yaml"
    cfg.write_text(yaml.safe_dump({"task": "lm", "lm": "transformer", "lm_conf": LM_CONF, "token_type": "char",
                                   "token_list": TOKENS, "training_settings": TRAINING}))
    return {"root": root, "text": str(path), "cfg": str(cfg)}


def _datasets(path, cfg_path):
    import lm_main as jlm
    from tailored_avsr_tpu.data import get_tokenizer_converter as jtok
    from tailored_avsr_tpu.utils import load_config as jload
    from tailored_avsr_tpu_torch import lm_main
    from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
    from tailored_avsr_tpu_torch.utils.config import load_config

    return (jlm.LMTextDataset(path, *jtok(jload(cfg_path))),
            lm_main.LMTextDataset(path, *get_tokenizer_converter(load_config(cfg_path))))


@pytest.mark.parametrize("mode", ["text", "csv"])
def test_dataset_and_batches_match_jax(text, mode):
    """The same ids a sentence from a text file (uppercased, braces and
    empty lines dropped) and from a split CSV's transcription files; the
    same shuffled, bucketed, -1-padded batches over two epochs."""
    import lm_main as jlm
    from tailored_avsr_tpu_torch import lm_main
    from tests.synthetic import make_synthetic_corpus

    path = text["text"] if mode == "text" else make_synthetic_corpus(str(text["root"] / "corpus"), n=6)[0]
    jds, pds = _datasets(path, text["cfg"])
    assert len(pds) == len(jds) == (9 if mode == "text" else 6)
    for a, b in zip(pds.ids, jds.ids):
        assert np.array_equal(a, b)
    jrng, prng = np.random.RandomState(0), np.random.RandomState(0)
    for shuffle in (True, True, False):
        want = [(np.asarray(t), np.asarray(n)) for t, n in jlm.lm_batches(jds, 4, shuffle, jrng)]
        got = [(t.numpy(), n.numpy()) for t, n in lm_main.lm_batches(pds, 4, shuffle, prng)]
        assert len(got) == len(want)
        for (gt, gn), (wt, wn) in zip(got, want):
            assert gt.dtype == wt.dtype and np.array_equal(gt, wt) and np.array_equal(gn, wn)


def test_three_train_steps_match_jax(text):
    """Three steps of the root ``lm_main.py``'s train step (its code, with
    dropout 0) and of the port's ``make_lm_train_step`` from the same
    weights and batches: each loss within 1e-5, every parameter after the
    third step within 1e-4, but the attention key biases: their exact
    gradient is 0 (a softmax does not see a shift of every key by one
    vector), so each package's gradient there is f32 rounding noise, which
    Adam's normalised update turns into steps of up to the learning rate;
    they are held to have moved by no more than the three learning rates
    in both."""
    import lm_main as jlm
    from tailored_avsr_tpu.tasks.lm import LMTask
    from tailored_avsr_tpu.train import create_train_state, set_optimizer as jset
    from tailored_avsr_tpu.train.loop import TrainState
    from tailored_avsr_tpu.utils import load_config as jload
    from tailored_avsr_tpu_torch import lm_main
    from tailored_avsr_tpu_torch.models.lm import TransformerLM
    from tailored_avsr_tpu_torch.train.optim import set_optimizer
    from tailored_avsr_tpu_torch.utils.convert import convert_jax_lm_variables
    from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict
    from test_torch_port_slice import _random_variables

    jds, pds = _datasets(text["text"], text["cfg"])
    cfg = jload(text["cfg"])
    jm = LMTask.build_model(cfg, [line.rstrip() for line in open(TOKENS) if line.rstrip()])
    toks, lens = next(jlm.lm_batches(jds, 4, False, np.random.RandomState(0)))
    variables = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), toks, lens)), seed=3)
    tx, _ = jset(TRAINING, model_size=64, steps_per_epoch=3)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)

    @jax.jit
    def train_step(state, toks, lens, rng):  # lm_main.py's train step
        def loss_fn(params):
            nll, counts = jm.apply({"params": params}, toks, lens, method="nll", deterministic=False,
                                   rngs={"dropout": jax.random.fold_in(rng, state.step)})
            return jnp.sum(nll) / jnp.maximum(jnp.sum(counts), 1)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        return TrainState(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                          batch_stats=state.batch_stats, opt_state=new_opt), loss

    lm = TransformerLM(jm.vocab_size, **LM_CONF)
    lm.load_state_dict(convert_jax_lm_variables(variables), strict=True)
    opt, _ = set_optimizer(TRAINING, 64, 3, lm.named_parameters())
    step = lm_main.make_lm_train_step(lm, opt, torch.Generator().manual_seed(0))
    batches = zip(jlm.lm_batches(jds, 4, True, np.random.RandomState(0)),
                  lm_main.lm_batches(pds, 4, True, np.random.RandomState(0)))
    for (jt, jn), (pt, pn) in batches:
        state, want = train_step(state, jt, jn, jax.random.PRNGKey(0))
        got = step(pt, pn)
        assert abs(float(got) - float(want)) <= 1e-5, (float(got), float(want))
    want = export_torch_state_dict({"params": jax.device_get(state.params)})
    start = export_torch_state_dict(variables)
    noam = sum(64 ** -0.5 * min(n ** -0.5, n * 10 ** -1.5) for n in (1, 2, 3))
    for k, v in lm.state_dict().items():
        if k.endswith("linear_k.bias"):
            for moved in (v.numpy() - start["lm." + k], want["lm." + k] - start["lm." + k]):
                assert np.abs(moved).max() <= noam * 1.001, k
            continue
        np.testing.assert_allclose(v.numpy(), want["lm." + k], rtol=0, atol=1e-4, err_msg=k)


def test_cli_trains_validates_averages_and_serves(text, tmp_path):
    """``--device cpu``, 2 epochs: a checkpoint an epoch, the average of
    both by perplexity, ``val_stats.csv`` with ``ppl``. The JAX
    ``load_model`` reads the average and its NLL equals the port's within
    1e-5; the port's ``Speech2Text`` decodes with it as its LM."""
    import __graft_entry__ as graft
    from tailored_avsr_tpu.tasks.lm import LMTask
    from tailored_avsr_tpu.train.checkpoint import load_model
    from tailored_avsr_tpu.utils import load_config as jload
    from tailored_avsr_tpu_torch import lm_main
    from tailored_avsr_tpu_torch.inference import Speech2Text
    from tailored_avsr_tpu_torch.models.lm import TransformerLM
    from tailored_avsr_tpu_torch.train.checkpoint import read_state_dict
    from tailored_avsr_tpu_torch.utils.config import load_config
    from tailored_avsr_tpu_torch.utils.convert import lm_state_dict
    from test_torch_port_slice import _batch, _random_variables

    out = str(tmp_path / "exp")
    res = lm_main.main(["--config-file", text["cfg"], "--training-dataset", text["text"], "--output-dir", out,
                        "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(out, "models"))) == ["model_001.pth", "model_002.pth",
                                                               "model_average.pth"]
    with open(os.path.join(out, "val_stats.csv")) as f:
        assert f.readline().strip() == "epoch,ppl" and len(f.readlines()) == 2
    assert all(np.isfinite(res["losses"])) and all(np.isfinite(res["ppl"]))

    vocab = len([line for line in open(TOKENS) if line.rstrip()])
    lm = TransformerLM(vocab, **LM_CONF).eval()
    lm.load_state_dict(lm_state_dict(read_state_dict(res["average"])), strict=True)
    jm = LMTask.build_model(jload(text["cfg"]), [line.rstrip() for line in open(TOKENS) if line.rstrip()])
    toks = np.array([[5, 9, 12, 7, -1], [3, 4, 5, 6, 8]], np.int32)
    lens = np.array([4, 5], np.int32)
    template = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), toks, lens)))
    jvars = load_model(template, res["average"])
    want = jm.apply(jvars, jnp.asarray(toks), jnp.asarray(lens), method="nll")[0]
    with torch.no_grad():
        got = lm.nll(torch.from_numpy(toks), torch.from_numpy(lens))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    cfg = graft._flagship_cfg(tiny=True)
    cfg.token_list = TOKENS
    cfg.inference_conf = dict(cfg.inference_conf, beam_size=2, nbest=1)
    s2t = Speech2Text(cfg, lm_config=load_config(text["cfg"]), lm_ckpt_path=res["average"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(s2t.lm.state_dict().values(), lm.state_dict().values()))
    hyps = s2t(_batch())
    assert len(hyps) == 2 and all(isinstance(h[0], str) for h in hyps)
