"""JAX (flax) variables -> a state dict in the reference's PyTorch key grammar.

The port's own copy of the export half of
``tailored_avsr_tpu/utils/torch_compat.py`` (``export_torch_state_dict`` and
the key grammar it needs), cut to the models the port builds: the tailored and the
conventional AVSR models (the latter with Branchformer or Conformer
stacks), the ASR / VSR models on the Branchformer, E-Branchformer,
Conformer, Transformer, Longformer and (VGG-)RNN encoders, every
attention decoder (Sim-T, the conv decoders, LSTM, S4), their Mask-CTC
and transducer variants and the Transformer LM. numpy only.
``tests/test_torch_port_int8.py`` holds it equal to the JAX package's
export, key for key and array for array.

Key mapping (flax path -> torch dotted key), by component:
- encoders: ``layer_{i}`` -> ``encoders.{i}``; conventional
  ``acoustic_layer_{i}`` -> ``acoustic_encoder.encoders.{i}`` and
  ``acoustic_after_norm`` -> ``acoustic_encoder.after_norm`` (visual
  likewise); embed stacks
  ``embed_conv/conv_{j}`` -> ``embed.conv.{2j}``, ``embed_conv/out`` ->
  ``embed.out.0`` (with pos-enc) or ``embed.out`` (AVSR embeds),
  ``embed_linear``/``embed_norm`` -> ``embed.0``/``embed.1``;
- tailored: ``acoustic_norm`` -> ``acoustic_norm_mha`` | ``acoustic_norm_cgmlp``
  after the branch the layer carries;
- decoder: ``layer_{i}`` -> ``decoders.{i}``, ``embed_tok`` -> ``embed.0``;
  every other name kept: a conv layer's ``conv_weight`` / ``conv_bias``,
  S4's ``s4_{i}`` (its six leaves as they are), ``src_attn_{i}``,
  ``ffn_{i}``, ``norms{1,2,3}_{i}``; the LSTM decoder's ``mlp_enc`` and
  ``step.{loc_conv, mlp_att, mlp_dec, gvec, lstm_{i}}``;
- RNN encoder: ``OptimizedLSTMCell_{n}`` (flax's names in creation order),
  ``proj_{i}``, ``vgg_conv{j}{a,b}``;
- transducer: ``prediction_network`` -> ``decoder`` (espnet's
  ``TransducerDecoder``), its ``embed_tok`` -> ``embed`` and ``lstm_{i}``
  -> ``decoder.{i}``, whose per-gate flax leaves (``ii``/``hi``, ... for
  gates i, f, g, o) are packed into torch's ``weight_ih_l0``,
  ``weight_hh_l0``, ``bias_hh_l0`` and a zero ``bias_ih_l0``;
  ``joint_network`` keeps its names; every other LSTM cell (the RNN
  encoder's and the LSTM decoder's) is packed the same way;
- LM (a tree with ``embed_tok`` and ``output_layer`` at its root): under
  ``lm.``, ``layer_{i}`` -> ``encoder.encoders.{i}``, ``in_linear`` /
  ``in_norm`` -> ``encoder.embed.0/1``, ``output_layer`` -> ``decoder``;
- visual frontend: ``frontend3d_conv``/``frontend3d_bn`` -> ``frontend3D.0/1``,
  ``layer{s}_block{b}`` -> ``trunk.layer{s}.{b}`` with ``downsample_conv/bn``
  -> ``downsample.0/1``;
- LayerNorm ``scale`` -> ``weight``; BatchNorm stats -> ``running_mean/var``;
- the ``stats`` collection (``GlobalMVN``'s corpus statistics, which the
  JAX package's own export drops) keeps its leaf names: ``normalize.mean``
  and ``normalize.std``; the multi-speaker encoder's ``sd{s}_layer_{i}``,
  the fused frontend's ``proj{i}`` and the pre / post-encoders'
  ``linear_out`` keep theirs.

Weight layouts: flax Linear (in, out) -> (out, in); Conv1d (k, in /
groups, out) -> (out, in / groups, k) (the depthwise convs, the conv1d
subsampling); Conv2d (kh, kw, in, out) -> (out, in, kh, kw);
Conv3d (kd, kh, kw, in, out) -> (out, in, kd, kh, kw).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np


def _is_lm_root(tree_root: Dict) -> bool:
    """An LM parameter tree, detected by its root modules."""
    return "embed_tok" in tree_root and "output_layer" in tree_root


def _rename_segments(path: List[str], tree_root: Dict) -> List[str]:
    """Translate flax path segments to torch dotted-path segments."""
    in_decoder = bool(path) and path[0] == "decoder"
    in_prednet = bool(path) and path[0] == "prediction_network"
    is_lm = _is_lm_root(tree_root)
    out: List[str] = ["lm"] if is_lm else []
    for seg in path:
        m = re.fullmatch(r"layer_(\d+)", seg)
        if m and is_lm:
            out.extend(["encoder", "encoders", m.group(1)])
        elif m:
            out.extend(["decoders" if in_decoder else "encoders", m.group(1)])
        elif is_lm and seg == "embed_tok":
            out.append("embed")
        elif is_lm and seg == "in_linear":
            out.extend(["encoder", "embed", "0"])
        elif is_lm and seg == "in_norm":
            out.extend(["encoder", "embed", "1"])
        elif is_lm and seg == "after_norm":
            out.extend(["encoder", "after_norm"])
        elif is_lm and seg == "output_layer":
            out.append("decoder")
        elif seg == "prediction_network":
            out.append("decoder")
        elif in_prednet and seg == "embed_tok":
            out.append("embed")
        elif in_prednet and re.fullmatch(r"lstm_(\d+)", seg):
            out.extend(["decoder", seg.split("_")[-1]])
        elif re.fullmatch(r"(acoustic|visual)_layer_(\d+)", seg):
            modality, _, i = seg.split("_")
            out.extend([f"{modality}_encoder", "encoders", i])
        elif seg in ("acoustic_after_norm", "visual_after_norm"):
            out.extend([f"{seg.split('_')[0]}_encoder", "after_norm"])
        elif seg in ("embed_tok", "embed_linear"):
            out.extend(["embed", "0"])
        elif seg == "embed_norm":
            out.extend(["embed", "1"])
        elif seg == "frontend3d_conv":
            out.extend(["frontend3D", "0"])
        elif seg == "frontend3d_bn":
            out.extend(["frontend3D", "1"])
        elif re.fullmatch(r"layer(\d)_block(\d)", seg):
            m2 = re.fullmatch(r"layer(\d)_block(\d)", seg)
            out.extend(["trunk", f"layer{m2.group(1)}", m2.group(2)])
        elif seg == "downsample_conv":
            out.extend(["downsample", "0"])
        elif seg == "downsample_bn":
            out.extend(["downsample", "1"])
        elif seg == "channel_proj1":
            out.extend(["channel_proj1", "0"])  # Sequential(Linear, GELU)
        else:
            out.append(seg)
    return out


def _embed_conv_fix(segs: List[str], in_avsr_embed: bool) -> List[str]:
    """embed_conv/conv_{j} -> embed.conv.{2j}; embed_conv/out -> embed.out[.0]."""
    out = []
    i = 0
    while i < len(segs):
        if segs[i] == "embed_conv":
            out.append("embed")
            nxt = segs[i + 1] if i + 1 < len(segs) else None
            if nxt and re.fullmatch(r"conv_(\d+)", nxt):
                out.extend(["conv", str(2 * int(nxt.split("_")[1]))])
                i += 2
                continue
            if nxt == "out":
                out.extend(["out"] if in_avsr_embed else ["out", "0"])
                i += 2
                continue
            i += 1
        else:
            out.append(segs[i])
            i += 1
    return out


_LEAF_RENAME = {
    "kernel": "weight",
    "scale": "weight",
    "embedding": "weight",
    "mean": "running_mean",
    "var": "running_var",
}


def _subtree(root: Dict, path: List[str]) -> Optional[Dict]:
    node = root
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def torch_key_for(path: List[str], params_root: Dict, rename_leaf: bool = True) -> str:
    """Full torch dotted key for a flax leaf path (the leaf's name kept
    without ``rename_leaf``)."""
    *mods, leaf = path
    in_avsr_embed = bool(mods) and mods[0] in ("acoustic_embed", "visual_embed")
    mods2 = []
    for i, seg in enumerate(mods):
        if seg in ("acoustic_norm", "visual_norm"):  # named after the layer's branch
            prefix = seg.split("_")[0]
            kind = "mha" if f"{prefix}_attn" in (_subtree(params_root, mods[:i]) or {}) else "cgmlp"
            mods2.append(f"{prefix}_norm_{kind}")
        else:
            mods2.append(seg)
    segs = _embed_conv_fix(_rename_segments(mods2, params_root), in_avsr_embed)
    return ".".join(segs + [_LEAF_RENAME.get(leaf, leaf) if rename_leaf else leaf])


# torch axis i of a kernel holds flax axis _KERNEL_PERMS[ndim][i]
_KERNEL_PERMS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _from_flax(value: np.ndarray, leaf: str) -> np.ndarray:
    """A flax leaf in torch's layout."""
    v = np.asarray(value)
    if leaf == "kernel" and v.ndim in _KERNEL_PERMS:
        v = v.transpose(_KERNEL_PERMS[v.ndim])
    return v


def torch_axis_of_flax_last(leaf: str, ndim: int) -> int:
    """The torch axis that holds a flax ``leaf``'s last axis after
    ``_from_flax`` (a kernel's output features; an embedding's width)."""
    if leaf == "kernel" and ndim in _KERNEL_PERMS:
        return _KERNEL_PERMS[ndim].index(ndim - 1)
    return ndim - 1


_LSTM_GATES = ("i", "f", "g", "o")  # torch's row order, the flax gate names


def _collapse_lstm_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-gate flax LSTM leaves (``{base}.i{g}.weight``, ``{base}.h{g}.weight``
    / ``.bias``) -> torch's packed ``{base}.weight_ih_l0``, ``weight_hh_l0``,
    ``bias_hh_l0`` and ``bias_ih_l0`` (zeros: torch adds the two biases)."""
    out = dict(sd)
    bases = {k[: -len(".ii.weight")] for k in sd if k.endswith(".ii.weight")}
    for base in bases:
        if any(f"{base}.h{g}.weight" not in sd for g in _LSTM_GATES):
            continue
        w_ih = np.concatenate([np.asarray(out.pop(f"{base}.i{g}.weight")) for g in _LSTM_GATES])
        w_hh = np.concatenate([np.asarray(out.pop(f"{base}.h{g}.weight")) for g in _LSTM_GATES])
        b_hh = np.concatenate([np.asarray(out.pop(f"{base}.h{g}.bias")) for g in _LSTM_GATES])
        out[f"{base}.weight_ih_l0"] = w_ih
        out[f"{base}.weight_hh_l0"] = w_hh
        out[f"{base}.bias_hh_l0"] = b_hh
        out[f"{base}.bias_ih_l0"] = np.zeros_like(b_hh)
    return out


def _walk(tree: Dict, path: List[str]):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + [k])
        else:
            yield path + [k], v


def export_torch_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """flax ``{'params': ..., 'batch_stats': ..., 'stats': ...}`` variables
    -> a state dict (numpy values) in the reference's PyTorch key grammar."""
    params_root = variables.get("params", {})
    out: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats", "stats"):
        for path, leaf_val in _walk(variables.get(collection, {}), []):
            out[torch_key_for(path, params_root, collection != "stats")] = _from_flax(np.asarray(leaf_val),
                                                                                       path[-1])
    return _collapse_lstm_keys(out)
