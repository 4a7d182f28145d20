"""Speech2Text: config + weights -> batched serving on one device
(counterpart of ``tailored_avsr_tpu/inference.py:133``): greedy CTC and the
label-synchronous joint CTC/attention beam search with Transformer-LM
shallow fusion over the ancestry KV cache, for the AVSR models (``task:
avsr``: tailored or conventional encoder) and the Branchformer ASR / VSR
models (``task: asr | vsr``: one ``speech`` stream), the model picked by
the task as the JAX engine picks it.

The constructor takes the JAX engine's arguments plus ``device``; the
weights come from ``ckpt_path`` / ``lm_ckpt_path`` (PyTorch state dicts in
the reference key grammar, as ``utils/torch_compat.export_torch_state_dict``
writes them; the LM's under ``lm.``) or, without them, from one
``torch.Generator`` seeded with ``rng_seed`` (the model first, then the LM).
Under ``dtype: bfloat16`` both run in bf16.

``greedy(batch) -> List[str]`` follows ``inference.py:1051``, including the
dequantisation of uint8 video and int16 audio on the device
(``inference.py:412-423``). ``nbest`` / ``__call__`` follow
``inference.py:954-982`` with the beam of ``inference.py:580-771``: the
decoder and the LM score each step through their never-reordered group
caches (``score_step_anc``, group attend K4), the step's columns are written
in place after the reorder (K5) and an (N, Lc) ancestry table tracks which
slot holds each column. ``inference_conf fused_group_attend: false`` takes
the plain group attend on the card (the JAX package's A/B switch).
``cache_dtype: int8`` stores the beam caches as int8 payloads with per-column
scales (group attend K6, quantised column writes through K5) and
``mem_dtype: int8`` the decoder's cross-attention memory K/V, as
``inference.py:218-246`` and ``:663-699`` do. The other protocols and decode
modes raise, naming their ``ROADMAP.md`` item.

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

The engine runs on the CUDA card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from tailored_avsr_tpu_torch import not_ported
from tailored_avsr_tpu_torch.decode.beam_search import (
    BeamSearchConfig,
    BeamSearchResult,
    beam_search,
    update_ancestry,
    write_beam_step,
)
from tailored_avsr_tpu_torch.decode.greedy import ctc_greedy_collapse
from tailored_avsr_tpu_torch.decode.maskctc import maskctc_decode
from tailored_avsr_tpu_torch.decode.transducer_beam import transducer_beam_search
from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask
from tailored_avsr_tpu_torch.ops.rnnt import multiblank_greedy_decode, transducer_greedy_decode
from tailored_avsr_tpu_torch.tasks import lm as lm_task
from tailored_avsr_tpu_torch.tasks.common import build_model, resolve_device, task_of
from tailored_avsr_tpu_torch.train.checkpoint import load_model, read_state_dict
from tailored_avsr_tpu_torch.utils.convert import lm_state_dict

_SPACE = "<space>"


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


def _check_inference_conf(inf: dict, ngram_path: Optional[str], dtype: torch.dtype) -> None:
    """Raise for each ``inference_conf`` choice the port does not run; the
    cache and memory dtypes as ``tailored_avsr_tpu/inference.py:218-246``."""
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
    if _DTYPE_NAMES.get(cache_dtype, dtype) != dtype:  # needs K4 with mixed query and cache types
        raise not_ported(f"cache_dtype: {cache_dtype} under a {str(dtype).replace('torch.', '')} model", 7)
    if str(inf.get("decode_mode", "label_sync")) != "label_sync":
        raise not_ported("decode_mode: timesync", 7)
    if protocol == "append":
        raise not_ported("cache_protocol: append", 7)
    if int(inf.get("cache_segments", 1)) > 1:
        raise not_ported("cache_segments > 1", 7)
    if ngram_path or inf.get("ngram_file"):
        raise not_ported("n-gram fusion", 7)
    if inf.get("quantize_asr_model") or inf.get("quantize_lm"):
        raise not_ported("quantised weights (quantize_asr_model / quantize_lm)", 7)
    if inf.get("data_parallel"):
        raise not_ported("data_parallel", 9)


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
        if mesh is not None:
            raise not_ported("mesh-parallel decoding", 9)
        self.task = task_of(config)
        token_type = getattr(config, "token_type", "char")
        if token_type != "char":
            raise not_ported(f"token_type {token_type!r}", 8)
        inf = _normalize_inference_conf(dict(getattr(config, "inference_conf", {}) or {}), config)
        self.dtype = (
            torch.bfloat16
            if str(getattr(config, "dtype", "float32")) in ("bfloat16", "bf16")
            else torch.float32
        )
        _check_inference_conf(inf, ngram_path, self.dtype)
        self.config = config
        self.token_list = load_token_list(config.token_list)
        self.device = resolve_device(device, "Speech2Text")
        self.quantized_cache = str(inf.get("cache_dtype", "") or "") == "int8"
        self.quantized_memory = str(inf.get("mem_dtype", "") or "") == "int8"
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

    def load_checkpoint(self, path: str) -> List[str]:
        """Strict load of a PyTorch state dict (``.pth`` / ``.pt``); keys the
        model has no module for (the decoder of a CTC-only model) are
        dropped and returned."""
        return load_model(self.model, path)

    def load_lm_checkpoint(self, path: str) -> None:
        """Strict load of an LM state dict in the ``lm.`` key grammar."""
        self.lm.load_state_dict(lm_state_dict(read_state_dict(path)), strict=True)

    def inputs(self, batch: Dict) -> Tuple[torch.Tensor, ...]:
        """The model's inputs on the device, (audio, audio_lengths, video,
        video_lengths) for avsr and (speech, speech_lengths) for asr / vsr
        (``tailored_avsr_tpu/inference.py:372-380``), ready for the model:
        uint8 video -> (x / video_scale - video_mean) / video_std and int16
        audio -> x / 32768, with -1 past each utterance's length (the pad
        value of the float path); every float stream in the model's dtype."""
        keys = ("audio", "audio_lengths", "video", "video_lengths") if self.task == "avsr" else (
            "speech", "speech_lengths")
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
        res, first = self._decode(batch)
        tokens, lengths, scores = (x.cpu().numpy() for x in (res.tokens, res.lengths, res.scores))
        results = []
        for i in range(tokens.shape[0]):
            hyps = []
            for j in range(tokens.shape[1]):
                ids = [int(t) for t in tokens[i, j, first:first + lengths[i, j]]]
                toks = [self.token_list[t] for t in ids]
                text = "".join(" " if t == _SPACE else t for t in toks)
                hyps.append((text, toks, ids, float(scores[i, j])))
            results.append(hyps)
        return results

    @torch.inference_mode()
    def _decode(self, batch: Dict) -> Tuple[BeamSearchResult, int]:
        """Encoder, then the model's search: the transducer's, Mask-CTC, or
        CTC log-probs and the label-synchronous beam. Returns the (B, n, L)
        result on the device and the column of each hypothesis' first token
        (1 after ``<sos>``, 0 where there is none)."""
        model = self.model
        if model.joint_network is None and model.decoder is None:
            raise not_ported("beam decoding of a CTC-only model (decode_mode: timesync)", 7)
        enc, enc_lens, _ = model.encode(*self.inputs(batch))
        if model.joint_network is not None:
            return self._transducer(enc, enc_lens), 0
        ctc_logp = model.ctc.log_softmax(enc)
        if self.is_maskctc:
            return self._maskctc(enc, enc_lens, ctc_logp), 0
        return self._beam(enc, enc_lens, ctc_logp), 1

    def _transducer(self, enc: torch.Tensor, enc_lens: torch.Tensor) -> BeamSearchResult:
        """``tailored_avsr_tpu/inference.py:447-503``: the ALSD beam, or the
        (multi-blank) greedy decode as one hypothesis with score 0."""
        model, k = self.model, self.beam_config.beam_size
        joint, pred = model.joint_network, model.prediction_network
        enc_proj = joint.lin_enc(enc)  # once for every frame

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

    def _beam(self, enc: torch.Tensor, enc_lens: torch.Tensor, ctc_logp: torch.Tensor) -> BeamSearchResult:
        cfg, dec, lm = self.beam_config, self.model.decoder, self.lm
        b, t, _ = enc.shape
        k = cfg.beam_size
        att_w = 1.0 - cfg.ctc_weight
        fold_lm = lm is not None and cfg.lm_weight > 0.0
        if fold_lm and att_w <= 0.0:
            raise not_ported("LM fusion with ctc_weight 1.0 (full-prefix LM scoring)", 7)
        mem_mask = make_valid_mask(enc_lens, t)
        mem_kv = dec.precompute_memory(enc)  # B rows, shared by each beam group
        if self.quantized_memory:  # once per request, per (b, h, t) column
            mem_kv = [(quantize_kv_column(mk), quantize_kv_column(mv)) for mk, mv in mem_kv]
        quantized = self.quantized_cache
        state = {
            "dec": dec.init_cache_group(b, k, t, dtype=enc.dtype, quantized=quantized),
            # as wide as the widest (8-rounded) group cache
            "anc": torch.zeros((b * k, -(-(t + 2) // 8) * 8), dtype=torch.int32, device=enc.device),
        }
        if fold_lm:
            state["lm"] = lm.init_cache_group(b, k, t + 2, dtype=enc.dtype, quantized=quantized)
            lm_scale = cfg.lm_weight / att_w
        fused = self.fused_group_attend

        def att_fn_for_width(width):
            def att_fn(ys, pos, st):
                lp, dec_new = dec.score_step_anc(mem_kv, mem_mask, ys, pos, st["dec"], st["anc"], k,
                                                 width, fused)
                st = dict(st, dec_new=dec_new)
                if fold_lm:
                    lm_lp, st["lm_new"] = lm.score_step_anc(ys, pos, st["lm"], st["anc"], k, width, fused)
                    lp = lp + lm_scale * lm_lp
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

        return beam_search(att_fn_for_width(None), ctc_logp, enc_lens, self.model.sos, self.model.eos,
                           cfg, att_state=state, att_gather_fn=att_gather_fn,
                           att_fn_for_width=att_fn_for_width)

    @torch.inference_mode()
    def greedy(self, batch: Dict) -> List[str]:
        """CTC greedy decoding: one transcript per utterance of the batch."""
        ids, lens = self.model.ctc_greedy(*self.inputs(batch))
        hyps = ctc_greedy_collapse(ids.cpu().numpy(), lens.cpu().numpy())
        return [
            "".join(" " if t == _SPACE else t for t in (self.token_list[i] for i in h))
            for h in hyps
        ]
