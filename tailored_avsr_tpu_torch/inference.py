"""Speech2Text: config + weights -> batched serving on one device
(counterpart of ``tailored_avsr_tpu/inference.py:133``): greedy CTC, the
label-synchronous joint CTC/attention beam search with Transformer-LM and
n-gram shallow fusion, and the time-synchronous CTC beam with decoder and
LM rescoring, for the AVSR models (``task: avsr``: tailored or
conventional encoder) and the Branchformer ASR / VSR models (``task: asr |
vsr``: one ``speech`` stream), the model picked by the task as the JAX
engine picks it.

The constructor takes the JAX engine's arguments plus ``device``; the
weights come from ``ckpt_path`` / ``lm_ckpt_path`` (PyTorch state dicts in
the reference key grammar, as ``utils/torch_compat.export_torch_state_dict``
writes them; the LM's under ``lm.``) or, without them, from one
``torch.Generator`` seeded with ``rng_seed`` (the model first, then the LM).
Under ``dtype: bfloat16`` both run in bf16.

``greedy(batch) -> List[str]`` follows ``inference.py:1051``, including the
dequantisation of uint8 video and int16 audio on the device
(``inference.py:412-423``). ``nbest`` / ``__call__`` follow
``inference.py:954-982``; the label-synchronous beam
(``inference.py:580-929``) runs one of three cache protocols:

- ``cache_protocol: anc`` (the default): the decoder and the LM score each
  step through their never-reordered group caches (``score_step_anc``,
  group attend K4), the step's columns are written in place after the
  reorder (the step write K5) and an (N, Lc) ancestry table tracks which
  slot holds each column. ``fused_group_attend: false`` takes the plain
  group attend on the card (the JAX package's A/B switch). ``cache_dtype``
  stores the group caches as ``int8`` payloads with per-column scales
  (K6, quantised column writes through K5), or in the other float type
  than the model's (K4 over a wider or narrower cache); ``mem_dtype:
  int8`` the decoder's cross-attention memory K/V (``inference.py:218-246``,
  ``:663-699``);
- ``cache_protocol: append``: (N, H, Lc, dk) caches read by the step and
  permuted with the step's column inserted after each reorder
  (``insert_permute_rows``);
- ``cache_segments`` > 1: the decoder's cache in length segments that
  the step writes and the reorder gathers only up to the live length
  (``score_step_cached_seg``), the LM's a plain cache it writes itself.

The LM rides in the decoder's scorer unless ``ctc_weight`` is 1.0; then it
scores each step's whole prefix (``TransformerLM.score_step``). A decoder
other than the Transformer (Sim-T, the conv decoders, ``rnn``, ``s4``) has
no cache step, as in the JAX engine (``inference.py:584``, ``:898-918``):
the beam scores it by its full-prefix ``score_step`` over the
beam-repeated memory, the LM by its full-prefix step, and the cache
options (``cache_protocol``, ``cache_segments``, ``cache_dtype``,
``mem_dtype``, ``phase_widths``) change nothing there, as in the JAX
engine, after the same checks at construction. An n-gram
(``ngram_file`` or the ``ngram_path`` argument, which wins, with
``ngram_weight`` > 0; ``decode/ngram.py``) joins the LM's scores rescaled
onto ``lm_weight`` or stands in the LM's place (``ngram_scorer: full``),
or scores the pre-beam candidates only (``part``). ``decode_mode:
timesync`` (``time_sync: true``), and every model without a decoder, runs
the time-synchronous CTC beam (``decode/ctc_timesync.py``, the n-gram in
its loop) and rescores its K hypotheses with the decoder's and the LM's
``nll`` (``inference.py:528-577``). ``quantize_asr_model`` /
``quantize_lm`` keep the model's / the LM's weights quantised on the device
(``utils/quantize.py``), from the first decode on.

``nbest`` dispatches as the JAX engine does (``inference.py:447-525``): a
transducer model (``decoder: transducer``) runs the ALSD beam
(``decode/transducer_beam.py``, ``max_symbols`` = T) when ``beam_size`` >
1 and it has no multi-blank durations, else the greedy transducer decode
(the multi-blank one, blank at ``len(durations)``, with durations); a
Mask-CTC model (``model: maskctc``) runs ``decode/maskctc.py`` with
``maskctc_n_iterations`` and ``maskctc_threshold_probability`` (0.999
unless set). Both return ids without ``<sos>``, the transducer beam all K
hypotheses, the others one with score 0; an ``lm_config`` takes no part in
them, as in the JAX engine. ``greedy`` is CTC greedy for every model.

The input side (``inference.py:985-1049``): ``device_put_batch`` uploads
a batch's model inputs (under ``device_normalize`` float audio first
becomes int16), and ``stream`` decodes an iterable of batches while the
next one uploads, on a side CUDA stream from pinned host memory.

The engine runs on the CUDA card unless ``device="cpu"`` is asked for.

``data_parallel: true`` (or any ``mesh`` passed, as the JAX engine takes
one) serves over the ranks of the process group (``parallel/mesh.py``;
``torchrun`` starts one process a card): the weights are broadcast from
rank 0, as the JAX engine replicates them over its mesh
(``inference.py:352-357``);
each rank decodes its rows of a batch (``greedy``, ``nbest``,
``__call__``, ``stream``, every decode mode) on its own device, and the
results are gathered in batch order, so every rank returns the same list.
A batch that does not divide over the ranks is decoded whole by every
rank, as the JAX engine falls back to replicated placement
(``inference.py:359-370``). Outside a process group there is one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.nn.utils import parametrize

from tailored_avsr_tpu_torch.data.tokenizer import get_tokenizer_converter
from tailored_avsr_tpu_torch.decode.beam_search import (
    BeamSearchConfig,
    BeamSearchResult,
    beam_search,
    insert_permute_rows,
    update_ancestry,
    write_beam_step,
)
from tailored_avsr_tpu_torch.decode.ctc_timesync import ctc_timesync_beam_search
from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse
from tailored_avsr_tpu_torch.decode.ngram import NgramScorer
from tailored_avsr_tpu_torch.decode.maskctc import maskctc_decode
from tailored_avsr_tpu_torch.decode.transducer_beam import transducer_beam_search
from tailored_avsr_tpu_torch.ops.attention import promoted_linear
from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask
from tailored_avsr_tpu_torch.ops.rnnt import multiblank_greedy_decode, transducer_greedy_decode
from tailored_avsr_tpu_torch.parallel import mesh as parallel_mesh
from tailored_avsr_tpu_torch.parallel.host_data import process_batch_slice
from tailored_avsr_tpu_torch.tasks import lm as lm_task
from tailored_avsr_tpu_torch.tasks.common import build_model, resolve_device, task_of
from tailored_avsr_tpu_torch.train.checkpoint import load_model, read_state_dict
from tailored_avsr_tpu_torch.utils.convert import lm_state_dict
from tailored_avsr_tpu_torch.utils.quantize import quantize_model
from tailored_avsr_tpu_torch.utils.tracing import call, span

def load_token_list(token_list) -> List[str]:
    """A token-list file (one token per line) or a list of tokens."""
    if isinstance(token_list, str):
        with open(token_list, encoding="utf-8") as f:
            return [line.rstrip() for line in f if line.rstrip()]
    return list(token_list)


_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# Every inference_conf key the JAX engine (or its avsr_main inference loader)
# honors, copied from ``tailored_avsr_tpu/inference.py:_INFERENCE_KEYS``: the
# reference splats inference_conf as keyword arguments, so an unknown key
# fails loudly there, and so it does here. Keys of choices the port does not
# run pass this set and are refused by ``_check_inference_conf``.
_INFERENCE_KEYS = frozenset({
    "beam_size", "ctc_weight", "lm_weight", "penalty", "maxlenratio",
    "minlenratio", "nbest", "early_exit", "unroll", "phase_widths",
    "maskctc_n_iterations", "maskctc_threshold_probability", "decode_mode",
    "pre_beam", "cache_segments", "fused_group_attend", "cache_protocol",
    "video_scale", "video_mean", "video_std", "device_normalize",
    "quantize_asr_model", "quantize_lm", "quantize_dtype",
    "quantize_min_size", "cache_dtype", "mem_dtype", "ngram_weight",
    "ngram_file",
    "ngram_scorer",
    "data_parallel",
    "batch_size",  # consumed by the avsr_main inference dataloader
    "hugging_face_decoder_max_length",  # inert without the gated hf decoder
})


def _normalize_inference_conf(inf: dict, config) -> dict:
    """Validate and translate the reference's inference_conf keys, as
    ``tailored_avsr_tpu/inference.py:_normalize_inference_conf`` does:
    ``time_sync`` becomes ``decode_mode: timesync``; ``transducer_conf``,
    ``quantize_modules`` beyond Linear / Embedding, ``streaming``,
    ``enh_s2t_task``, ``multi_asr`` and ``hugging_face_decoder`` raise
    NotImplementedError; ``dtype``, ``token_type`` and ``bpemodel`` must
    agree with the top-level config; an unknown key raises ValueError."""
    inf = dict(inf)
    if inf.pop("time_sync", False):  # reference name for the timesync beam
        mode = inf.setdefault("decode_mode", "timesync")
        if mode != "timesync":
            raise ValueError(f"time_sync: true conflicts with decode_mode: {mode!r}")
    scorer = inf.get("ngram_scorer", "full")
    if scorer not in ("full", "part"):
        raise ValueError(f"ngram_scorer must be 'full' or 'part', got {scorer!r}")
    if inf.pop("transducer_conf", None):
        raise NotImplementedError("transducer_conf options are not configurable")
    qmods = inf.pop("quantize_modules", None)
    if qmods is not None and not set(qmods) <= {"Linear", "Embedding"}:
        raise NotImplementedError(
            f"quantize_modules {qmods!r}: weight-only quantization covers Dense kernels and embeddings")
    inf.pop("device", None)  # the engine's device is its constructor's argument
    dtype = inf.pop("dtype", None)
    if dtype is not None and dtype != getattr(config, "dtype", "float32"):
        raise ValueError(
            f"inference_conf dtype {dtype!r} disagrees with the top-level config dtype "
            f"{getattr(config, 'dtype', 'float32')!r}: set the top-level key")
    for key in ("token_type", "bpemodel"):
        val, cfg_val = inf.pop(key, None), getattr(config, key, None)
        if val is not None and cfg_val is not None and val != cfg_val:
            raise ValueError(
                f"inference_conf {key} {val!r} disagrees with the top-level config ({cfg_val!r})")
    for key in ("streaming", "enh_s2t_task", "multi_asr", "hugging_face_decoder"):
        if inf.pop(key, False):
            raise NotImplementedError(f"inference_conf {key} is not built")
    unknown = set(inf) - _INFERENCE_KEYS
    if unknown:
        raise ValueError(
            f"unknown inference_conf key(s) {sorted(unknown)}; known keys: {sorted(_INFERENCE_KEYS)}")
    return inf


def _check_inference_conf(inf: dict) -> None:
    """The cache protocol and the cache and memory dtypes, checked as
    ``tailored_avsr_tpu/inference.py:212-246`` checks them."""
    protocol = str(inf.get("cache_protocol", "anc"))
    if protocol not in ("anc", "append"):
        raise ValueError(f"cache_protocol must be 'anc' or 'append', got {protocol!r}")
    cache_dtype = str(inf.get("cache_dtype", "") or "")
    if cache_dtype not in ("", "bfloat16", "float32", "int8"):
        raise NotImplementedError(
            f"cache_dtype={cache_dtype!r}: supported values are '' (compute dtype), 'bfloat16', "
            "'float32', 'int8'")
    if cache_dtype == "int8" and protocol != "anc":
        raise NotImplementedError("cache_dtype: int8 requires cache_protocol: anc")
    mem_dtype = str(inf.get("mem_dtype", "") or "")
    if mem_dtype not in ("", "int8"):
        raise NotImplementedError(
            f"mem_dtype={mem_dtype!r}: supported values are '' (compute dtype) and 'int8'")
    if mem_dtype == "int8" and protocol != "anc":
        raise NotImplementedError("mem_dtype: int8 requires cache_protocol: anc")


def _cast_kv(new_kv, dtype: torch.dtype) -> list:
    """A scorer's step columns in the model's dtype, the dtype the JAX
    engine's beam state keeps them in (``inference.py:635-641``)."""
    return [(kn.to(dtype), vn.to(dtype)) for kn, vn in new_kv]


class Speech2Text:
    def __init__(
        self,
        config,
        ckpt_path: Optional[str] = None,
        lm_config=None,
        lm_ckpt_path: Optional[str] = None,
        ngram_path: Optional[str] = None,
        rng_seed: int = 0,
        mesh=None,
        *,
        device=None,
    ):
        self.task = task_of(config)
        # char, word or none (a YAML null: tokens joined by spaces); bpe
        # needs sentencepiece, as in the JAX engine
        self.tokenizer, _ = get_tokenizer_converter(config)
        inf = _normalize_inference_conf(dict(getattr(config, "inference_conf", {}) or {}), config)
        self.dtype = (
            torch.bfloat16
            if str(getattr(config, "dtype", "float32")) in ("bfloat16", "bf16")
            else torch.float32
        )
        _check_inference_conf(inf)
        self.config = config
        self.token_list = load_token_list(config.token_list)
        self.device = resolve_device(device, "Speech2Text")
        # over the ranks of the process group (one rank outside one)
        self.data_parallel = mesh is not None or bool(inf.get("data_parallel", False))
        if self.data_parallel and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())  # the rank's card
        cache_dtype = str(inf.get("cache_dtype", "") or "")
        self.quantized_cache = cache_dtype == "int8"
        self.cache_dtype = _DTYPE_NAMES.get(cache_dtype)  # None: the model's dtype
        self.quantized_memory = str(inf.get("mem_dtype", "") or "") == "int8"
        self.cache_protocol = str(inf.get("cache_protocol", "anc"))
        self.cache_segments = int(inf.get("cache_segments", 1))
        self.decode_mode = str(inf.get("decode_mode", "label_sync"))
        # the beam (``unroll`` is accepted and not used: the port runs one
        # step per iteration, the result-exact form)
        self.beam_config = BeamSearchConfig(
            beam_size=int(inf.get("beam_size", 30)),
            ctc_weight=float(inf.get("ctc_weight", 0.1)),
            lm_weight=float(inf.get("lm_weight", 0.0)) if lm_config is not None else 0.0,
            penalty=float(inf.get("penalty", 0.0)),
            maxlenratio=float(inf.get("maxlenratio", 0.0)),
            minlenratio=float(inf.get("minlenratio", 0.0)),
            nbest=int(inf.get("nbest", 1)),
            early_exit=bool(inf.get("early_exit", True)),
            phase_widths=tuple(inf.get("phase_widths", ()) or ()),
            # the int8 cache phases at the JAX package's int8 tile
            width_tile=32 if self.quantized_cache else 8,
        )
        # the time-sync beam's pre-beam: 1.5 x the beam unless set (espnet's ratio)
        self.pre_beam = int(inf.get("pre_beam", int(1.5 * self.beam_config.beam_size)))
        # group-attend choice per engine: None = K4 on the card, plain on the CPU
        fga = inf.get("fused_group_attend", None)
        self.fused_group_attend = None if fga is None else bool(fga)
        self.is_maskctc = getattr(config, "model", "espnet") == "maskctc"
        self.maskctc_n_iterations = int(inf.get("maskctc_n_iterations", 10))
        self.maskctc_threshold = float(inf.get("maskctc_threshold_probability", 0.999))

        generator = torch.Generator().manual_seed(rng_seed)
        self.model = build_model(config, self.token_list, generator=generator,
                                 device=self.device, dtype=self.dtype)
        if ckpt_path:
            self.load_checkpoint(ckpt_path)
        self.lm = None
        if lm_config is not None:
            lm_tokens = getattr(lm_config, "token_list", None)
            lm_tokens = load_token_list(lm_tokens) if isinstance(lm_tokens, str) else self.token_list
            self.lm = lm_task.build_model(lm_config, lm_tokens, generator=generator,
                                          device=self.device, dtype=self.dtype)
            if lm_ckpt_path:
                self.load_lm_checkpoint(lm_ckpt_path)
        elif lm_ckpt_path:
            raise ValueError("lm_ckpt_path needs lm_config")
        # quantised inputs: uint8 video / int16 audio (host transform chain
        # Normalise(0, 250) + Normalise(mean, std), as in the JAX engine)
        self.video_scale = float(inf.get("video_scale", 250.0))
        self.video_mean = float(inf.get("video_mean", 0.421))
        self.video_std = float(inf.get("video_std", 0.165))
        self.quantize_audio = bool(inf.get("device_normalize", False))
        # weight-only quantisation, applied at the first decode (the JAX
        # engine's ensure_params), so weights loaded after construction count
        self.quantize_asr_model = bool(inf.get("quantize_asr_model", False))
        self.quantize_lm = bool(inf.get("quantize_lm", False))
        self.quantize_dtype = str(inf.get("quantize_dtype", "qint8"))
        self.quantize_min_size = int(inf.get("quantize_min_size", 4096))
        self._quantize_pending = self.quantize_asr_model or (self.quantize_lm and self.lm is not None)
        # n-gram fusion: 'full' rides the LM slot, 'part' scores the pre-beam candidates
        self.ngram = None
        self.ngram_weight = float(inf.get("ngram_weight", 0.0))
        self.ngram_mode = str(inf.get("ngram_scorer", "full"))
        ngram_path = ngram_path or inf.get("ngram_file")
        if ngram_path and self.ngram_weight > 0:
            self.ngram = NgramScorer(ngram_path, self.token_list, device=self.device)
        self._replicate()

    def _replicate(self) -> None:
        """Rank 0's weights on every rank, when serving data-parallel."""
        if self.data_parallel and parallel_mesh.world_size() > 1:
            for m in (self.model, getattr(self, "lm", None)):
                if m is not None:
                    parallel_mesh.replicate(m)

    def _rows(self, batch: Dict) -> Optional[slice]:
        """This rank's rows of ``batch`` when serving data-parallel, or None:
        one rank, or a batch that does not divide over the ranks (decoded
        whole)."""
        world = parallel_mesh.world_size()
        if not self.data_parallel or world == 1:
            return None
        b = next(len(batch[k]) for k in self._DEVICE_KEYS if k in batch)
        if b % world:
            return None
        return process_batch_slice(b, parallel_mesh.global_rank(), world)

    def _data_parallel(self, decode, batch: Dict) -> list:
        """``decode`` of this rank's rows, gathered from every rank in batch order."""
        rows = self._rows(batch)
        if rows is None:
            return decode(batch)
        local = {k: (v[rows] if k in self._DEVICE_KEYS else v) for k, v in batch.items()}
        return [r for part in parallel_mesh.all_gather_objects(decode(local)) for r in part]

    def _ensure_quantized(self) -> None:
        """Quantise the weights ``quantize_asr_model`` / ``quantize_lm`` name,
        once, before the first decode, outside inference mode (the payloads
        are kept across calls). Each ``greedy`` / ``nbest`` call then runs
        under ``parametrize.cached()``: every weight is dequantised once a
        call, as the JAX decode graph dequantises at its top."""
        if not self._quantize_pending:
            return
        if self.quantize_asr_model:
            quantize_model(self.model, self.quantize_dtype, self.quantize_min_size)
        if self.quantize_lm and self.lm is not None:
            quantize_model(self.lm, self.quantize_dtype, self.quantize_min_size)
        self._quantize_pending = False

    def load_checkpoint(self, path: str) -> List[str]:
        """Strict load of a PyTorch state dict (``.pth`` / ``.pt``); keys the
        model has no module for (the decoder of a CTC-only model) are
        dropped and returned. Serving data-parallel, every rank loads, and
        rank 0's weights are kept."""
        dropped = load_model(self.model, path)
        self._replicate()
        return dropped

    def load_lm_checkpoint(self, path: str) -> None:
        """Strict load of an LM state dict in the ``lm.`` key grammar."""
        self.lm.load_state_dict(lm_state_dict(read_state_dict(path)), strict=True)
        self._replicate()

    def inputs(self, batch: Dict) -> Tuple[torch.Tensor, ...]:
        """The model's inputs on the device, (audio, audio_lengths, video,
        video_lengths) for avsr and (speech, speech_lengths) for asr / vsr
        (``tailored_avsr_tpu/inference.py:372-380``), ready for the model:
        uint8 video -> (x / video_scale - video_mean) / video_std and int16
        audio -> x / 32768, with -1 past each utterance's length (the pad
        value of the float path); every float stream in the model's dtype."""
        keys = ("audio", "audio_lengths", "video", "video_lengths") if self.task == "avsr" else (
            "speech", "speech_lengths")
        with span("s2t.inputs"):
            args = [torch.as_tensor(batch[k], device=self.device) for k in keys]
            for i, a in enumerate(args):
                if a.dim() < 2:
                    continue  # length vectors
                if a.dtype == torch.uint8:
                    x = (a.float() / self.video_scale - self.video_mean) / self.video_std
                elif a.dtype == torch.int16:
                    x = a.float() / 32768.0
                else:
                    args[i] = a.to(self.dtype)
                    continue
                lengths = args[i + 1]  # (tensor, lengths) pairs by convention
                valid = torch.arange(x.shape[1], device=x.device) < lengths[:, None]
                x = torch.where(valid.reshape(valid.shape + (1,) * (x.dim() - 2)), x, -1.0)
                args[i] = x.to(self.dtype)
        return tuple(args)

    def __call__(self, batch: Dict) -> List[Tuple[str, List[str], List[int]]]:
        """Batch dict -> [(text, tokens, ids)] per utterance (1-best)."""
        return [hyps[0][:3] for hyps in self.nbest(batch)]

    def nbest(self, batch: Dict) -> List[List[Tuple[str, List[str], List[int], float]]]:
        """Batch dict -> per utterance the n-best list [(text, tokens, ids,
        score)], best first."""
        with call("s2t.nbest"):
            return self._data_parallel(self._nbest, batch)

    def _nbest(self, batch: Dict) -> List[List[Tuple[str, List[str], List[int], float]]]:
        self._ensure_quantized()
        with torch.inference_mode(), parametrize.cached():
            res, first = self._decode(batch)
        with span("s2t.readback"):
            tokens, lengths, scores = (x.cpu().numpy() for x in (res.tokens, res.lengths, res.scores))
        with span("s2t.detokenize"):
            results = []
            for i in range(tokens.shape[0]):
                hyps = []
                for j in range(tokens.shape[1]):
                    ids = [int(t) for t in tokens[i, j, first:first + lengths[i, j]]]
                    toks = [self.token_list[t] for t in ids]
                    hyps.append((self.text(toks), toks, ids, float(scores[i, j])))
                results.append(hyps)
        return results

    def _decode(self, batch: Dict) -> Tuple[BeamSearchResult, int]:
        """Encoder, then the model's search: the transducer's, Mask-CTC, or
        CTC log-probs and the label-synchronous beam. Returns the (B, n, L)
        result on the device and the column of each hypothesis' first token
        (1 after ``<sos>``, 0 where there is none)."""
        model = self.model
        self._single_speaker()
        inputs = self.inputs(batch)
        with span("s2t.forward"):
            enc, enc_lens, _ = model.encode(*inputs)
            ctc_logp = None if model.joint_network is not None else model.ctc.log_softmax(enc)
        if model.joint_network is not None:
            return self._transducer(enc, enc_lens), 0
        if self.is_maskctc:
            return self._maskctc(enc, enc_lens, ctc_logp), 0
        if self.decode_mode == "timesync" or model.decoder is None:
            return self._timesync(enc, enc_lens, ctc_logp), 0
        return self._beam(enc, enc_lens, ctc_logp), 1

    def _transducer(self, enc: torch.Tensor, enc_lens: torch.Tensor) -> BeamSearchResult:
        """``tailored_avsr_tpu/inference.py:447-503``: the ALSD beam, or the
        (multi-blank) greedy decode as one hypothesis with score 0."""
        model, k = self.model, self.beam_config.beam_size
        joint, pred = model.joint_network, model.prediction_network
        enc_proj = promoted_linear(joint.lin_enc, enc)  # once for every frame

        def joint_apply(enc_t, g):
            return joint.from_projected(enc_t, g)

        durations = model.transducer_multi_blank_durations
        b, t = enc.shape[:2]
        if k > 1 and not durations:  # espnet decodes multi-blank models greedily
            res = transducer_beam_search(enc_proj, enc_lens, pred.step, joint_apply, pred.initial_state(b * k),
                                         beam_size=k, max_symbols=t)
            return BeamSearchResult(tokens=res.tokens, scores=res.scores, lengths=res.lengths)
        if durations:
            toks, count = multiblank_greedy_decode(enc_proj, enc_lens, pred.step, joint_apply,
                                                   pred.initial_state(b), blank_id=len(durations),
                                                   durations=durations)
        else:
            toks, count = transducer_greedy_decode(enc_proj, enc_lens, pred.step, joint_apply,
                                                   pred.initial_state(b))
        return BeamSearchResult(tokens=toks[:, None], scores=torch.zeros((b, 1), device=enc.device),
                                lengths=count[:, None])

    def _maskctc(self, enc: torch.Tensor, enc_lens: torch.Tensor, ctc_logp: torch.Tensor) -> BeamSearchResult:
        """``tailored_avsr_tpu/inference.py:508-525``: Mask-CTC as one
        hypothesis with score 0; the MLM runs the full decoder each round."""
        model = self.model
        mem_mask = make_valid_mask(enc_lens, enc.shape[1])
        res = maskctc_decode(ctc_logp, enc_lens, lambda ys, lens: model.decoder(enc, mem_mask, ys, lens),
                             model.mask_token, threshold=self.maskctc_threshold,
                             num_iterations=self.maskctc_n_iterations, eos=model.eos)
        return BeamSearchResult(tokens=res.tokens[:, None], scores=torch.zeros((enc.shape[0], 1), device=enc.device),
                                lengths=res.lengths[:, None])

    def _timesync(self, enc: torch.Tensor, enc_lens: torch.Tensor, ctc_logp: torch.Tensor) -> BeamSearchResult:
        """``tailored_avsr_tpu/inference.py:528-577``: the time-synchronous
        CTC beam (the n-gram in its loop), its CTC scores weighted by
        ``ctc_weight`` and its fusion terms at full weight, then the K
        hypotheses rescored by the decoder's and the LM's ``nll``, batched;
        the ``nbest`` best."""
        cfg, model, k = self.beam_config, self.model, self.beam_config.beam_size
        v, ngram = ctc_logp.shape[-1], self.ngram
        toks, tlens, tscores, cscores = ctc_timesync_beam_search(
            ctc_logp, enc_lens, beam_size=k, pre_beam=min(self.pre_beam, v - 1), max_len=max(2, enc.shape[1]),
            penalty=cfg.penalty, ngram_scorer=ngram.score_candidates if ngram is not None else None,
            ngram_weight=self.ngram_weight if ngram is not None else 0.0)
        score = cfg.ctc_weight * cscores + (tscores - cscores)
        att_w = 1.0 - cfg.ctc_weight
        b, _, lmax = toks.shape
        flens = tlens.reshape(-1)
        flat = torch.where(torch.arange(lmax, device=toks.device)[None] < flens[:, None], toks.reshape(b * k, lmax), -1)
        if model.decoder is not None and att_w > 0:
            nll = model.nll(enc.repeat_interleave(k, 0), enc_lens.repeat_interleave(k, 0), flat, flens)
            score = score + att_w * -nll.reshape(b, k)
        if self.lm is not None and cfg.lm_weight > 0:
            score = score + cfg.lm_weight * -self.lm.nll(flat, flens)[0].reshape(b, k)
        order = torch.sort(-score, dim=1, stable=True).indices[:, :min(cfg.nbest, k)]
        return BeamSearchResult(tokens=torch.gather(toks, 1, order[..., None].expand(-1, -1, lmax)),
                                scores=torch.gather(score, 1, order), lengths=torch.gather(tlens, 1, order))

    def _beam(self, enc: torch.Tensor, enc_lens: torch.Tensor, ctc_logp: torch.Tensor) -> BeamSearchResult:
        """The label-synchronous beam (``tailored_avsr_tpu/inference.py:580-929``):
        a Transformer decoder over the configured cache protocol with the LM
        folded into its scorer; any other decoder (Sim-T, the conv
        decoders, ``rnn``, ``s4``: the JAX engine's ``use_cache`` false) by
        its full-prefix ``score_step`` over the beam-repeated memory, the
        LM then by its own full-prefix step, and the cache options
        ignored, as the JAX engine ignores them there."""
        cfg, dec, lm = self.beam_config, self.model.decoder, self.lm
        ngram, ngram_w = self.ngram, self.ngram_weight
        if ngram is not None and self.ngram_mode == "part":
            cfg = dataclasses.replace(cfg, ngram_weight=ngram_w)
        elif ngram is not None and lm is None:  # the n-gram alone takes the LM's slot
            cfg = dataclasses.replace(cfg, lm_weight=ngram_w)
        ngram_full = ngram if self.ngram_mode == "full" else None
        b, t, _ = enc.shape
        k, dt = cfg.beam_size, enc.dtype
        n = b * k
        att_w = 1.0 - cfg.ctc_weight
        use_cache = getattr(dec, "layer_variant", None) == "transformer"
        fold_lm = use_cache and lm is not None and cfg.lm_weight > 0.0 and att_w > 0.0
        lm_scale = cfg.lm_weight / att_w if fold_lm else 0.0

        def with_ngram(lm_lp, ys, pos):  # the full n-gram rescaled onto the LM weight
            if ngram_full is None:
                return lm_lp
            return lm_lp + (ngram_w / cfg.lm_weight) * ngram_full.score_step(ys, pos)

        mem_mask = make_valid_mask(enc_lens, t)
        att_fn_for_width = state = att_gather_fn = None
        n_seg = max(1, min(self.cache_segments, t))
        if not use_cache:
            mem, mm = enc.repeat_interleave(k, 0), mem_mask.repeat_interleave(k, 0)

            def att_fn(ys, pos):
                return self.model.decoder_score_step(mem, mm, ys, pos)
        elif self.cache_protocol == "anc" and n_seg == 1:
            mem_kv = dec.precompute_memory(enc)  # B rows, shared by each beam group
            att_fn_for_width, state, att_gather_fn = self._anc_protocol(
                enc, mem_kv, mem_mask, fold_lm, lm_scale, with_ngram, cfg)
            att_fn = att_fn_for_width(None)
        else:
            mem_kv = [(mk.repeat_interleave(k, 0), mv.repeat_interleave(k, 0))
                      for mk, mv in dec.precompute_memory(enc)]
            mem_mask = mem_mask.repeat_interleave(k, 0)
            seg = n_seg > 1
            state = {"dec": dec.init_cache_seg(n, t, dtype=dt, num_segments=n_seg) if seg
                     else dec.init_cache(n, t, dtype=dt)}
            if fold_lm:
                state["lm"] = lm.init_cache(n, t + 2, dtype=dt)

            def att_fn(ys, pos, st):
                if seg:  # the segmented decoder and the LM write their caches themselves
                    st = dict(st)
                    lp, st["dec"] = dec.score_step_cached_seg(mem_kv, mem_mask, ys, pos, st["dec"])
                    if fold_lm:
                        lm_lp, st["lm"] = lm.score_step_cached(ys, pos, st["lm"])
                        lp = lp + lm_scale * with_ngram(lm_lp, ys, pos)
                    return lp, st
                lp, dec_new = dec.score_step_append(mem_kv, mem_mask, ys, pos, st["dec"])
                st = dict(st, dec_new=_cast_kv(dec_new, dt))
                if fold_lm:
                    lm_lp, lm_new = lm.score_step_append(ys, pos, st["lm"])
                    lp = lp + lm_scale * with_ngram(lm_lp, ys, pos)
                    st["lm_new"] = _cast_kv(lm_new, dt)
                return lp, st

            def att_gather_fn(st, g_src, pos):
                if seg:
                    out = {"dec": type(dec).gather_cache_seg(st["dec"], g_src, pos)}
                    if fold_lm:
                        out["lm"] = [tuple(x[g_src] for x in layer) for layer in st["lm"]]
                    return out
                src_bk = g_src.reshape(-1, k) % k  # the reorder with the step's columns inserted
                return {side: [(insert_permute_rows(ck, kn, src_bk, pos), insert_permute_rows(cv, vn, src_bk, pos))
                               for (ck, cv), (kn, vn) in zip(st[side], st[side + "_new"])]
                        for side in (("dec", "lm") if fold_lm else ("dec",))}

        lm_fn = None
        if lm is not None and cfg.lm_weight > 0.0 and not fold_lm:
            def lm_fn(ys, pos):  # the full-prefix LM (ctc_weight 1.0)
                return with_ngram(lm.score_step(ys, pos), ys, pos)
        elif ngram_full is not None:
            lm_fn = ngram_full.score_step
        return beam_search(att_fn, ctc_logp, enc_lens, self.model.sos, self.model.eos, cfg, lm_score_fn=lm_fn,
                           att_state=state, att_gather_fn=att_gather_fn, att_fn_for_width=att_fn_for_width,
                           ngram_part_fn=ngram.score_step_candidates if ngram is not None and self.ngram_mode == "part"
                           else None)

    def _anc_protocol(self, enc, mem_kv, mem_mask, fold_lm: bool, lm_scale: float, with_ngram, cfg):
        """The ancestry protocol's (scorer of a width, state, gather): group
        caches in ``cache_dtype`` (int8 payloads with scales, or a float
        type), the memory K/V int8 under ``mem_dtype: int8``."""
        dec, lm = self.model.decoder, self.lm
        b, t, _ = enc.shape
        k, dt = cfg.beam_size, enc.dtype
        if self.quantized_memory:  # once per request, per (b, h, t) column
            mem_kv = [(quantize_kv_column(mk), quantize_kv_column(mv)) for mk, mv in mem_kv]
        quantized, cache_dt = self.quantized_cache, self.cache_dtype or dt
        state = {
            "dec": dec.init_cache_group(b, k, t, dtype=cache_dt, quantized=quantized),
            # as wide as the widest (8-rounded) group cache
            "anc": torch.zeros((b * k, -(-(t + 2) // 8) * 8), dtype=torch.int32, device=enc.device),
        }
        if fold_lm:
            state["lm"] = lm.init_cache_group(b, k, t + 2, dtype=cache_dt, quantized=quantized)
        fused = self.fused_group_attend

        def att_fn_for_width(width):
            def att_fn(ys, pos, st):
                lp, dec_new = dec.score_step_anc(mem_kv, mem_mask, ys, pos, st["dec"], st["anc"], k, width, fused)
                st = dict(st, dec_new=_cast_kv(dec_new, dt))
                if fold_lm:
                    lm_lp, lm_new = lm.score_step_anc(ys, pos, st["lm"], st["anc"], k, width, fused)
                    lp = lp + lm_scale * with_ngram(lm_lp, ys, pos)
                    st["lm_new"] = _cast_kv(lm_new, dt)
                return lp, st
            return att_fn

        def att_gather_fn(st, g_src, pos):
            # every slot writes the column it computed, every layer in one
            # launch (in place, after this step's attends); the ancestry
            # table follows the reorder
            write_beam_step([(ck, cv, kn, vn) for side in (("dec", "lm") if fold_lm else ("dec",))
                             for (ck, cv), (kn, vn) in zip(st[side], st.pop(side + "_new"))], pos)
            st["anc"] = update_ancestry(st["anc"], g_src, g_src.reshape(-1, k) % k, pos)
            return st

        return att_fn_for_width, state, att_gather_fn

    # -- the input side: uploads that overlap the decode ----------------------
    _DEVICE_KEYS = ("audio", "audio_lengths", "video", "video_lengths", "speech", "speech_lengths")

    def device_put_batch(self, batch: Dict) -> Dict:
        """The batch with its model inputs on the device (host-only keys, refs
        and text, pass through): copies from pinned host memory, issued on
        the current stream without waiting. Under ``device_normalize`` float
        audio (2-D ``audio`` / ``speech``) first becomes int16,
        ``clip(a * 32768, -32768, 32767)``, half the bytes; ``inputs``
        dequantises it on the device."""
        out = dict(batch)
        with span("s2t.device_put"):
            for key in self._DEVICE_KEYS:
                if key not in out or (torch.is_tensor(out[key]) and out[key].device == self.device):
                    continue
                a = out[key].numpy() if torch.is_tensor(out[key]) else np.asarray(out[key])
                if self.quantize_audio and key in ("audio", "speech") and a.ndim == 2 and a.dtype == np.float32:
                    a = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
                x = torch.from_numpy(np.ascontiguousarray(a))
                if self.device.type == "cuda":
                    x = x.pin_memory().to(self.device, non_blocking=True)
                out[key] = x
        return out

    def stream(self, batches: Iterable[Dict], nbest: bool = False) -> Iterator[Tuple[Dict, list]]:
        """Decode an iterable of batches -> (batch on the device, results)
        pairs, ``nbest`` or ``__call__`` results. A worker thread uploads
        batch i + 1 while batch i decodes, as the JAX engine's does; on the
        card the upload runs on a side stream, the decode stream waits on an
        event recorded after it, and the uploaded tensors are marked as used
        by the decode stream, so no copy races the decode that reads it."""
        from concurrent.futures import ThreadPoolExecutor

        decode = self.nbest if nbest else self.__call__
        it = iter(batches)
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def upload(batch):
            if batch is None or not cuda:
                return (None if batch is None else self.device_put_batch(batch)), None
            with torch.cuda.stream(side):
                out = self.device_put_batch(batch)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(upload, next(it, None))
            while True:
                cur, done = pending.result()
                if cur is None:
                    return
                if cuda:
                    main = torch.cuda.current_stream(self.device)
                    main.wait_event(done)
                    for key in self._DEVICE_KEYS:
                        if torch.is_tensor(cur.get(key)):
                            cur[key].record_stream(main)
                pending = pool.submit(upload, next(it, None))  # overlaps this batch's decode
                yield cur, decode(cur)

    def greedy(self, batch: Dict) -> List[str]:
        """CTC greedy decoding: one transcript per utterance of the batch."""
        with call("s2t.greedy"):
            return self._data_parallel(self._greedy, batch)

    def _greedy(self, batch: Dict) -> List[str]:
        self._ensure_quantized()
        self._single_speaker()
        with torch.inference_mode(), parametrize.cached():
            inputs = self.inputs(batch)
            with span("s2t.forward"):
                ids, lens = self.model.ctc_greedy(*inputs)
        with span("s2t.readback"):
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        with span("s2t.detokenize"):
            return [self.text([self.token_list[i] for i in h]) for h in ctc_greedy_collapse(ids, lens)]

    def _single_speaker(self) -> None:
        """A ``pit_espnet`` model's encoder gives one encoding per speaker:
        it trains, and neither engine decodes it (the JAX engine's decode
        fails on its (B, num_inf, T, D) output with a TypeError)."""
        if hasattr(self.model, "num_inf"):
            raise TypeError("Speech2Text decodes single-speaker models; a pit_espnet model's encoder gives "
                            f"{self.model.num_inf} encodings an utterance")

    def text(self, tokens: List[str]) -> str:
        """A hypothesis' text: the tokenizer's (``token_type`` char: ``<space>``
        is a space; word: tokens joined by spaces), or the tokens joined by
        spaces without one."""
        return self.tokenizer.tokens2text(tokens) if self.tokenizer else " ".join(tokens)
