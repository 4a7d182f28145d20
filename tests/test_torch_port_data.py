"""The port's data path and evaluation against the JAX package's, on the
CPU: tokenizers and the id converter, the audio and video transforms under
the same numpy seeds, the split-CSV dataset (read with ``csv``, where the JAX
package uses pandas), the bucketed loader (shuffle, padding, workers),
the WER / CER scorers, and the config overrides. Everything here is numpy:
equal means bit-equal.
"""

import os

import numpy as np
import pytest

from tailored_avsr_tpu.data import dataloader as jloader
from tailored_avsr_tpu.data import dataset as jdataset
from tailored_avsr_tpu.data import tokenizer as jtok
from tailored_avsr_tpu.data import transforms_audio as jta
from tailored_avsr_tpu.data import transforms_video as jtv
from tailored_avsr_tpu.evaluation import wer as jwer
from tailored_avsr_tpu_torch.data import dataloader as ploader
from tailored_avsr_tpu_torch.data import dataset as pdataset
from tailored_avsr_tpu_torch.data import tokenizer as ptok
from tailored_avsr_tpu_torch.data import transforms_audio as pta
from tailored_avsr_tpu_torch.data import transforms_video as ptv
from tailored_avsr_tpu_torch.evaluation import wer as pwer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")), n=7, seed=3)


def _config(token_list, token_type="char"):
    import argparse

    return argparse.Namespace(token_list=token_list, token_type=token_type)


@pytest.mark.parametrize("token_type", ["char", "word"])
def test_tokenizers_and_converter_match_jax(corpus, token_type):
    _, tokens = corpus
    jt, jc = jtok.get_tokenizer_converter(_config(tokens, token_type))
    pt, pc = ptok.get_tokenizer_converter(_config(tokens, token_type))
    assert pc.token_list == jc.token_list and pc.unk_id == jc.unk_id
    for text in ("ABA CAD", "HID  BIG", "XYZ A"):
        assert pt.text2tokens(text) == jt.text2tokens(text)
        assert pc.tokens2ids(pt.text2tokens(text)) == jc.tokens2ids(jt.text2tokens(text))
        assert pt.tokens2text(pt.text2tokens(text)) == jt.tokens2text(jt.text2tokens(text))


def test_spm_without_sentencepiece_and_unknown_types_raise(corpus):
    _, tokens = corpus
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="sentencepiece"):
            ptok.SPMTokenizer("missing.model")
    for token_type, exc in (("phn", NotImplementedError), ("whisper", NotImplementedError),
                            ("bytes", ValueError)):
        with pytest.raises(exc):
            ptok.get_tokenizer_converter(_config(tokens, token_type))
    with pytest.raises(ValueError, match="<unk>"):
        ptok.TokenIDConverter(["<blank>", "a"])


def _audio_pair(cls_j, cls_p, x, seed, **kw):
    tj = cls_j(rng=np.random.RandomState(seed), **kw)
    tp = cls_p(rng=np.random.RandomState(seed), **kw)
    return [tj(x) for _ in range(4)], [tp(x) for _ in range(4)]


def test_audio_transforms_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(16000 * 2).astype(np.float32)
    noise = rs.randn(12000).astype(np.float32)
    cases = [(jta.SpeedRate, pta.SpeedRate, {}), (jta.TimeMasking, pta.TimeMasking, {}),
             (jta.AddNoise, pta.AddNoise, {"noise": noise}),
             (jta.AddNoise, pta.AddNoise, {"noise": rs.randn(50000).astype(np.float32)}),
             (jta.AddNoise, pta.AddNoise, {"noise": noise, "snr_target": 5})]
    for cls_j, cls_p, kw in cases:
        want, got = _audio_pair(cls_j, cls_p, x, 7, **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_video_transforms_match_jax():
    rs = np.random.RandomState(1)
    x = (rs.rand(30, 96, 96) * 250).astype(np.float32)
    for cls_j, cls_p in ((jtv.RandomCrop, ptv.RandomCrop), (jtv.HorizontalFlip, ptv.HorizontalFlip),
                         (jtv.TimeMasking, ptv.TimeMasking), (jtv.VideoSpeedRate, ptv.VideoSpeedRate)):
        want, got = _audio_pair(cls_j, cls_p, x, 3)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    for tj, tp in ((jtv.CenterCrop((88, 88)), ptv.CenterCrop((88, 88))),
                   (jtv.Normalise(0.421, 0.165), ptv.Normalise(0.421, 0.165)),
                   (jtv.QuantizeUint8(), ptv.QuantizeUint8())):
        np.testing.assert_array_equal(tp(x), tj(x))
    assert ptv.Compose is pta.Compose


def test_dataset_reads_the_split_csv_as_jax(corpus):
    csv_path, _ = corpus
    for limit, training in ((None, False), (12, True)):
        jd = jdataset.AVSRDataset(csv_path, nframes_limit=limit, is_training=training)
        pd_ = pdataset.AVSRDataset(csv_path, nframes_limit=limit, is_training=training)
        assert len(pd_) == len(jd)
        for i in range(len(jd)):
            w, g = jd[i], pd_[i]
            assert g.keys() == w.keys() and g["sample_id"] == w["sample_id"]
            assert g["transcription"] == w["transcription"]
            np.testing.assert_array_equal(g["audio"], w["audio"])
            np.testing.assert_array_equal(g["video"], w["video"])
    assert len(pdataset.AVSRDataset(csv_path, nframes_limit=12, is_training=True)) < 7


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("training", [False, True])
def test_loader_batches_match_jax(corpus, workers, training):
    """Same shuffle, buckets, padding and transforms (seeded numpy RNGs):
    every batch equal, with one read thread and with a pool."""
    csv_path, tokens = corpus

    def batches(dataset_mod, loader_mod, tok_mod, ta, tv):
        tokenizer, converter = tok_mod.get_tokenizer_converter(_config(tokens))
        ds = dataset_mod.AVSRDataset(csv_path, is_training=training)
        audio_tf = ta.Compose([ta.SpeedRate(rng=np.random.RandomState(5))])
        video_tf = ta.Compose([tv.Normalise(0.0, 250.0), tv.RandomCrop((88, 88), rng=np.random.RandomState(6))])
        loader = loader_mod.AVSRDataLoader(ds, 3, audio_transforms=audio_tf, video_transforms=video_tf,
                                           tokenizer=tokenizer, converter=converter, is_training=training,
                                           seed=4, workers=workers)
        assert len(loader) == 3
        return list(loader)

    want = batches(jdataset, jloader, jtok, jta, jtv)
    got = batches(pdataset, ploader, ptok, pta, ptv)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    assert got[0]["audio"].shape[1] % (640 * 8) == 0 and got[0]["video"].shape[1] % 8 == 0


def test_loader_pads_uint8_video_with_zero_and_propagates_errors(corpus):
    csv_path, tokens = corpus
    tokenizer, converter = ptok.get_tokenizer_converter(_config(tokens))
    ds = pdataset.AVSRDataset(csv_path, is_training=False)
    loader = ploader.AVSRDataLoader(ds, 4, video_transforms=ptv.QuantizeUint8(), tokenizer=tokenizer,
                                    converter=converter, is_training=False)
    batch = next(iter(loader))
    assert batch["video"].dtype == np.uint8
    short = int(np.argmin(batch["video_lengths"]))
    assert (batch["video"][short, batch["video_lengths"][short]:] == 0).all()
    assert (batch["text"][batch["text"] < 0] == -1).all()

    class Broken:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise OSError("unreadable sample")

    with pytest.raises(OSError, match="unreadable"):
        list(ploader.AVSRDataLoader(Broken(), 1, tokenizer=tokenizer, converter=converter))


def test_round_up_and_pad_batch():
    assert [ploader.round_up(x, 8) for x in (0, 1, 8, 9)] == [jloader.round_up(x, 8) for x in (0, 1, 8, 9)]
    arrs = [np.ones((3, 2), np.float32), np.ones((1, 2), np.float32)]
    np.testing.assert_array_equal(ploader.pad_batch(arrs, -1.0, 4), jloader.pad_batch(arrs, -1.0, 4))


def test_wer_scorers_match_jax(tmp_path):
    pairs = [("HOLA MUNDO", "HOLA MUNDO"), ("EL NIÑO", "EL NINO"), ("A B C", "A C"), ("", "X")]
    assert pwer.edit_distance("kitten", "sitting") == jwer.edit_distance("kitten", "sitting") == 3
    for words in (True, False):
        assert pwer.error_rate(pairs, words) == jwer.error_rate(pairs, words)
        assert pwer.bootstrap_error_rate(pairs, words, 200, 3) == jwer.bootstrap_error_rate(pairs, words, 200, 3)
    path = str(tmp_path / "x.inf")
    pwer.write_inf_file(path, pairs)
    assert pwer.read_inf_file(path) == jwer.read_inf_file(path) == pairs
    wer, cer, ci_w, ci_c = pwer.compute_bootstrap_wer(path, resamples=200, seed=3)
    assert (wer, ci_w) == pwer.bootstrap_error_rate(pairs, True, 200, 3)
    assert (cer, ci_c) == pwer.bootstrap_error_rate(pairs, False, 200, 3)
    refs, hyps = [[1, 2, 3], [4]], [[1, 3], [4, 4]]
    assert pwer.cer_from_ids(refs, hyps) == jwer.cer_from_ids(refs, hyps) == 50.0


@pytest.mark.parametrize("overrides", [
    ["training_settings:epochs:3", "encoder_conf:use_flash:true", "dtype:bfloat16"],
    ["model_conf:ctc_weight:0.3", "new_section:key:[1, 2]"],
])
def test_config_overrides_match_jax(overrides):
    from tailored_avsr_tpu.utils.config import load_config as jload
    from tailored_avsr_tpu_torch.utils.config import load_config

    path = os.path.join(ROOT, "configs/AVSR/tailored_transformer+ctc_spanish_tpu.yaml")
    assert vars(load_config(path, overrides)) == vars(jload(path, overrides))
    with pytest.raises(ValueError, match="CONF:KEY:VALUE"):
        load_config(path, ["a:b:c:d"])


def test_security_checks_refuse_what_jax_refuses():
    import argparse

    from tailored_avsr_tpu.utils.config import security_checks as jcheck
    from tailored_avsr_tpu_torch.utils.config import security_checks

    for avg, epochs in ((1, 1), (10, 100), (0, 3), (5, 3)):
        cfg = argparse.Namespace(training_settings={"average_epochs": avg, "epochs": epochs})
        try:
            jcheck(cfg)
            jax_ok = True
        except AssertionError:
            jax_ok = False
        if jax_ok:
            security_checks(cfg)
        else:
            with pytest.raises(ValueError, match="average_epochs"):
                security_checks(cfg)
