"""Speech2Text: config + weights -> batched serving on one device
(counterpart of ``tailored_avsr_tpu/inference.py:133``): greedy CTC and the
label-synchronous joint CTC/attention beam search with Transformer-LM
shallow fusion over the ancestry KV cache.

The constructor takes the JAX engine's arguments plus ``device``; the
weights come from ``ckpt_path`` / ``lm_ckpt_path`` (PyTorch state dicts in
the reference key grammar, as ``utils/torch_compat.export_torch_state_dict``
writes them; the LM's under ``lm.``) or, without them, from one
``torch.Generator`` seeded with ``rng_seed`` (the model first, then the LM).
Under ``dtype: bfloat16`` both run in bf16.

``greedy(batch) -> List[str]`` follows ``inference.py:1051``, including the
dequantisation of uint8 video and int16 audio on the device
(``inference.py:247-255``). ``nbest`` / ``__call__`` follow
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
from tailored_avsr_tpu_torch.ops.kv_quant import quantize_kv_column
from tailored_avsr_tpu_torch.ops.masking import make_valid_mask
from tailored_avsr_tpu_torch.tasks import lm as lm_task
from tailored_avsr_tpu_torch.tasks.avsr import build_model, resolve_device
from tailored_avsr_tpu_torch.utils.convert import filter_state_dict, lm_state_dict

_SPACE = "<space>"


def load_token_list(token_list) -> List[str]:
    """A token-list file (one token per line) or a list of tokens."""
    if isinstance(token_list, str):
        with open(token_list, encoding="utf-8") as f:
            return [line.rstrip() for line in f if line.rstrip()]
    return list(token_list)


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: only PyTorch state dicts load into the port; convert a JAX "
            "checkpoint with tailored_avsr_tpu_torch.utils.convert first"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return sd


_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    if inf.get("time_sync") or str(inf.get("decode_mode", "label_sync")) != "label_sync":
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
        task = getattr(config, "task", "avsr")
        if task != "avsr":
            raise not_ported(f"task {task!r}", 8)
        token_type = getattr(config, "token_type", "char")
        if token_type != "char":
            raise not_ported(f"token_type {token_type!r}", 8)
        inf = dict(getattr(config, "inference_conf", {}) or {})
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
        kept, dropped = filter_state_dict(self.model, _load_state_dict(path))
        self.model.load_state_dict(kept, strict=True)
        return dropped

    def load_lm_checkpoint(self, path: str) -> None:
        """Strict load of an LM state dict in the ``lm.`` key grammar."""
        self.lm.load_state_dict(lm_state_dict(_load_state_dict(path)), strict=True)

    def inputs(self, batch: Dict) -> Tuple[torch.Tensor, ...]:
        """(audio, audio_lengths, video, video_lengths) on the device, ready
        for the model: uint8 video -> (x / video_scale - video_mean) /
        video_std and int16 audio -> x / 32768, with -1 past each utterance's
        length (the pad value of the float path); every float stream in the
        model's dtype."""
        args = [
            torch.as_tensor(batch[k], device=self.device)
            for k in ("audio", "audio_lengths", "video", "video_lengths")
        ]
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
        res = self._decode(batch)
        tokens, lengths, scores = (x.cpu().numpy() for x in (res.tokens, res.lengths, res.scores))
        results = []
        for i in range(tokens.shape[0]):
            hyps = []
            for j in range(tokens.shape[1]):
                ids = [int(t) for t in tokens[i, j, 1:1 + lengths[i, j]]]
                toks = [self.token_list[t] for t in ids]
                text = "".join(" " if t == _SPACE else t for t in toks)
                hyps.append((text, toks, ids, float(scores[i, j])))
            results.append(hyps)
        return results

    @torch.inference_mode()
    def _decode(self, batch: Dict) -> BeamSearchResult:
        """Encoder, CTC log-probs and the label-synchronous beam; the result
        stays on the device."""
        if self.model.decoder is None:
            raise not_ported("beam decoding of a CTC-only model (decode_mode: timesync)", 7)
        enc, enc_lens, _ = self.model.encode(*self.inputs(batch))
        ctc_logp = self.model.ctc.log_softmax(enc)
        return self._beam(enc, enc_lens, ctc_logp)

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
