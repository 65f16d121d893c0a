"""FLUX LoRA files (port of ``diffusion_rs_tpu/io/lora.py``; diffusers-format
safetensors).

Semantics follow diffusers' PEFT fusion: ``delta_W = (alpha / r) * lora_B @
lora_A`` with torch ``[out, in]`` factors (lora_A ``[r, in]``, lora_B
``[out, r]``). Accepted key shapes:

* ``transformer.<base>.lora_A.weight`` / ``.lora_B.weight`` (diffusers PEFT);
* ``<base>.lora_down.weight`` / ``.lora_up.weight`` (kohya suffixes on
  diffusers key bodies), with optional ``transformer.`` /
  ``diffusion_model.`` prefixes and optional per-pair ``.alpha`` scalars;
* ``lora_unet_double_blocks_N_img_attn_qkv`` etc. (sd-scripts / kohya FLUX
  LoRAs in BFL naming): factors on the BFL fused projections are split per
  part by rows of B (the rank is kept). On trees with fused ``qkv`` /
  ``qkv_mlp`` linears each part's factors are placed in its column range.

Application, on the weights' own device:

* dense bases: the delta is fused, ``w[l] += s * A.T @ B.T`` in f32 and cast
  back (the Linear gets a new weight tensor; the old one is not written);
* quantized bases: the factors become the Linear's runtime low-rank term
  ``y += (x @ a) @ bl`` (ops/linear.py), the scale folded into ``bl``;
  per-layer factors of stacked blocks are zero-padded to one rank and
  stacked ``[L, K, r]`` / ``[L, r, N]``; a second file's terms concatenate
  along the rank.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.linear import Linear
from ..quant.qtensor import QuantizedTensor
from .safetensors import SafeTensors

log = logging.getLogger("diffusion_rs_tpu_torch")

_PREFIXES = ("transformer.", "diffusion_model.", "")
_A_SUFFIXES = (".lora_A.weight", ".lora_down.weight")
_B_SUFFIXES = (".lora_B.weight", ".lora_up.weight")


def _factor(st: SafeTensors, name: str) -> np.ndarray:
    """A stored factor as numpy in its own dtype (bf16 widened to f32)."""
    if st.info(name).dtype == "BF16":
        return st.tensor(name).float().numpy()
    return np.array(st.numpy(name))


def read_lora_file(path: str) -> Dict[str, dict]:
    """A LoRA safetensors file -> {base key: {"A", "B"[, "alpha"]}}; keys
    missing a partner are dropped with a warning."""
    st = SafeTensors.from_file(path)
    pairs: Dict[str, dict] = {}

    def strip_prefix(k: str) -> str:
        for p in _PREFIXES:
            if p and k.startswith(p):
                return k[len(p):]
        return k

    for name in st.keys():
        k = strip_prefix(name)
        for suf in _A_SUFFIXES:
            if k.endswith(suf):
                pairs.setdefault(k[: -len(suf)], {})["A"] = _factor(st, name)
        for suf in _B_SUFFIXES:
            if k.endswith(suf):
                pairs.setdefault(k[: -len(suf)], {})["B"] = _factor(st, name)
        if k.endswith(".alpha"):
            pairs.setdefault(k[: -len(".alpha")], {})["alpha"] = float(
                _factor(st, name).reshape(()))
    bad = [k for k, v in pairs.items() if "A" not in v or "B" not in v]
    for k in bad:
        del pairs[k]
    if bad:
        log.warning("LoRA %s: %d keys missing an A/B partner: %s...", path, len(bad), bad[:3])
    return pairs


# diffusers FluxTransformer2D base key -> path in the param tree
# (io/builders.py's names)
_DOUBLE_MAP = {
    "norm1.linear": ("img_mod",),
    "norm1_context.linear": ("txt_mod",),
    "attn.to_q": ("img_attn", "q"),
    "attn.to_k": ("img_attn", "k"),
    "attn.to_v": ("img_attn", "v"),
    "attn.to_out.0": ("img_attn", "proj"),
    "attn.add_q_proj": ("txt_attn", "q"),
    "attn.add_k_proj": ("txt_attn", "k"),
    "attn.add_v_proj": ("txt_attn", "v"),
    "attn.to_add_out": ("txt_attn", "proj"),
    "ff.net.0.proj": ("img_mlp", "in"),
    "ff.net.2": ("img_mlp", "out"),
    "ff_context.net.0.proj": ("txt_mlp", "in"),
    "ff_context.net.2": ("txt_mlp", "out"),
}
_SINGLE_MAP = {
    "attn.to_q": ("q",),
    "attn.to_k": ("k",),
    "attn.to_v": ("v",),
    "proj_mlp": ("proj_mlp",),
    "proj_out": ("linear2",),
    "norm.linear": ("mod",),
}
_TOP_MAP = {
    "x_embedder": ("img_in",),
    "context_embedder": ("txt_in",),
    "time_text_embed.timestep_embedder.linear_1": ("time_in", "in"),
    "time_text_embed.timestep_embedder.linear_2": ("time_in", "out"),
    "time_text_embed.text_embedder.linear_1": ("vector_in", "in"),
    "time_text_embed.text_embedder.linear_2": ("vector_in", "out"),
    "time_text_embed.guidance_embedder.linear_1": ("guidance_in", "in"),
    "time_text_embed.guidance_embedder.linear_2": ("guidance_in", "out"),
    "norm_out.linear": ("final", "mod"),
    "proj_out": ("final", "proj"),
}
_BFL_SIMPLE = {
    "img_in": "x_embedder",
    "txt_in": "context_embedder",
    "time_in_in_layer": "time_text_embed.timestep_embedder.linear_1",
    "time_in_out_layer": "time_text_embed.timestep_embedder.linear_2",
    "vector_in_in_layer": "time_text_embed.text_embedder.linear_1",
    "vector_in_out_layer": "time_text_embed.text_embedder.linear_2",
    "guidance_in_in_layer": "time_text_embed.guidance_embedder.linear_1",
    "guidance_in_out_layer": "time_text_embed.guidance_embedder.linear_2",
}


def _kohya_bfl_to_diffusers(pairs: Dict[str, dict], cfg) -> Dict[str, dict]:
    """``lora_unet_*`` bases (BFL underscore naming) -> diffusers bases,
    splitting the factors of BFL fused projections (double ``qkv``; single
    ``linear1`` = q|k|v|mlp columns) by rows of B. Unmatched bases pass
    through and surface in the caller's error."""
    h, mlp = cfg.hidden_size, cfg.mlp_size
    out: Dict[str, dict] = {}

    for base, pair in pairs.items():
        if not base.startswith("lora_unet_"):
            out[base] = pair
            continue
        body = base[len("lora_unet_"):]
        A, B = pair["A"], pair["B"]

        def put(newbase, b_part, pair=pair, A=A):
            d = {"A": A, "B": b_part}
            if "alpha" in pair:
                d["alpha"] = pair["alpha"]
            out[newbase] = d

        m = re.match(r"double_blocks_(\d+)_(img|txt)_"
                     r"(attn_qkv|attn_proj|mlp_0|mlp_2|mod_lin)$", body)
        if m:
            i, st, kind = int(m.group(1)), m.group(2), m.group(3)
            p = f"transformer_blocks.{i}"
            img = st == "img"
            if kind == "attn_qkv":
                names = ([f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v"] if img else
                         [f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj",
                          f"{p}.attn.add_v_proj"])
                for j, nm in enumerate(names):
                    put(nm, B[j * h:(j + 1) * h])
            elif kind == "attn_proj":
                put(f"{p}.attn.to_out.0" if img else f"{p}.attn.to_add_out", B)
            elif kind == "mlp_0":
                put(f"{p}.ff.net.0.proj" if img else f"{p}.ff_context.net.0.proj", B)
            elif kind == "mlp_2":
                put(f"{p}.ff.net.2" if img else f"{p}.ff_context.net.2", B)
            else:  # mod_lin
                put(f"{p}.norm1.linear" if img else f"{p}.norm1_context.linear", B)
            continue
        m = re.match(r"single_blocks_(\d+)_(linear1|linear2|modulation_lin)$", body)
        if m:
            i, kind = int(m.group(1)), m.group(2)
            p = f"single_transformer_blocks.{i}"
            if kind == "linear1":
                put(f"{p}.attn.to_q", B[0:h])
                put(f"{p}.attn.to_k", B[h:2 * h])
                put(f"{p}.attn.to_v", B[2 * h:3 * h])
                put(f"{p}.proj_mlp", B[3 * h:3 * h + mlp])
            elif kind == "linear2":
                put(f"{p}.proj_out", B)
            else:
                put(f"{p}.norm.linear", B)
            continue
        if body == "final_layer_linear":
            put("proj_out", B)
            continue
        if body == "final_layer_adaLN_modulation_1":
            # BFL emits (shift, scale); the tree is diffusers' (scale, shift):
            # swap the halves of B as the weight loader swaps the weight's
            put("norm_out.linear", np.concatenate([B[h:2 * h], B[0:h]]))
            continue
        if body in _BFL_SIMPLE:
            put(_BFL_SIMPLE[body], B)
            continue
        out[base] = pair
    return out


def _classify(base: str) -> Optional[Tuple[str, Optional[int], tuple]]:
    """base key -> (section, layer index, tree path), or None."""
    for prefix, section, table in (("transformer_blocks.", "double", _DOUBLE_MAP),
                                   ("single_transformer_blocks.", "single", _SINGLE_MAP)):
        if base.startswith(prefix):
            idx, _, tail = base[len(prefix):].partition(".")
            path = table.get(tail)
            return (section, int(idx), path) if path else None
    path = _TOP_MAP.get(base)
    return ("top", None, path) if path else None


_QKV_OFF = {"q": 0, "k": 1, "v": 2}


def _resolve_target(params, section, tree_path, cfg):
    """The Linear of a diffusers-style target, following the BFL fused
    layouts: on ``qkv`` / ``qkv_mlp`` trees a per-part target is a column
    range of the fused linear. Returns (linear, col_off, n_part); col_off
    is None for a whole-linear target."""
    h = cfg.hidden_size
    node = params[section] if section in ("double", "single") else params
    if section == "single":
        last = tree_path[0]
        if last in node:
            return node[last], None, None
        if last in _QKV_OFF and "qkv_mlp" in node:
            return node["qkv_mlp"], _QKV_OFF[last] * h, h
        if last == "proj_mlp" and "qkv_mlp" in node:
            return node["qkv_mlp"], 3 * h, cfg.mlp_size
        raise KeyError(tree_path)
    for p in tree_path[:-1]:
        node = node[p]
    last = tree_path[-1]
    if last in node:
        return node[last], None, None
    if last in _QKV_OFF and "qkv" in node:
        return node["qkv"], _QKV_OFF[last] * h, h
    raise KeyError(tree_path)


def _merge_lora(existing, a, bl):
    """Stack a new runtime term onto an existing one (several LoRA files):
    the ranks concatenate, ``y += (x @ [a1 | a2]) @ [[bl1], [bl2]]``."""
    if existing is None:
        return (a, bl)
    a0, bl0 = existing
    return torch.cat([a0, a], dim=-1), torch.cat([bl0, bl], dim=-2)


def _fuse_dense(w: torch.Tensor, layer: Optional[int], A, B, s: float,
                col_off: Optional[int] = None) -> None:
    """``w`` ([L, K, N] or [K, N]) += s * A.T @ B.T in f32, cast back, in the
    column range [col_off, col_off + B.rows) when col_off is set; in place,
    on ``w``'s device."""
    dev = w.device
    a = torch.from_numpy(np.ascontiguousarray(A, np.float32)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(B, np.float32)).to(dev)
    delta = (a.T @ b.T) * s
    cols = slice(None) if col_off is None else slice(col_off, col_off + B.shape[0])
    dst = w[:, cols] if layer is None else w[layer, :, cols]
    dst.copy_((dst.float() + delta).to(w.dtype))


def apply_flux_lora(params, cfg, path: str, scale: float = 1.0, dtype=torch.bfloat16):
    """Apply a LoRA file to a FLUX param tree in place (returns the tree).

    ``scale`` multiplies each pair's alpha / r (diffusers' ``lora_scale``).
    Text-encoder groups are skipped with a warning; keys that match nothing
    in the FLUX key map raise, since a partial application would change
    outputs without a word."""
    pairs = read_lora_file(path)
    if not pairs:
        raise ValueError(f"{path}: no LoRA A/B pairs found")
    te_prefixes = ("text_encoder.", "text_encoder_2.", "te1.", "te2.",
                   "lora_te1_", "lora_te2_", "lora_te_")
    te_keys = [k for k in pairs if k.startswith(te_prefixes)]
    for k in te_keys:
        del pairs[k]
    if te_keys:
        log.warning("LoRA %s: skipping %d text-encoder adapter groups (encoders "
                    "take no adapters here)", path, len(te_keys))
    if not pairs:
        raise ValueError(f"{path}: only text-encoder adapters present; nothing to apply")
    pairs = _kohya_bfl_to_diffusers(pairs, cfg)
    unmatched = []
    grouped: Dict[tuple, dict] = {}  # (section, tree path) -> {layer: (A, B, s)}
    n_layers = {"double": cfg.num_layers, "single": cfg.num_single_layers}
    for base, pair in pairs.items():
        cls = _classify(base)
        if cls is None:
            unmatched.append(base)
            continue
        section, layer, tree_path = cls
        if section == "top" and tree_path[0] == "guidance_in" and not cfg.guidance_embeds:
            continue  # a LoRA trained on dev carries factors schnell has no use for
        A, B = pair["A"], pair["B"]
        r = A.shape[0]
        s = scale * (pair.get("alpha", r) / r)
        grouped.setdefault((section, tree_path), {})[layer] = (A, B, s)
    if unmatched:
        raise ValueError(
            f"{path}: {len(unmatched)} LoRA keys do not match the FLUX transformer "
            f"key map, e.g. {sorted(unmatched)[:5]} — only diffusers-format FLUX "
            "LoRAs are supported")

    # every target to its physical Linear first: on fused trees several
    # per-part targets land on one linear and merge into one term
    physical: Dict[int, dict] = {}
    for (section, tree_path), per_layer in grouped.items():
        lin, col_off, _ = _resolve_target(params, section, tree_path, cfg)
        if not isinstance(lin, Linear):
            raise TypeError(f"LoRA target {section}/{tree_path} is not a Linear")
        rec = physical.setdefault(id(lin), {"lin": lin, "section": section, "entries": []})
        for layer, (A, B, s) in per_layer.items():
            rec["entries"].append((layer, A, B, s, col_off))

    n_applied = 0
    for rec in physical.values():
        lin, section = rec["lin"], rec["section"]
        n_applied += len(rec["entries"])
        if isinstance(lin.w, QuantizedTensor):
            k, n = lin.w.shape
            dev = lin.w.packed.device

            def b_full(A, B, s, off):
                bf = np.zeros((A.shape[0], n), np.float32)
                cols = slice(0, n) if off is None else slice(off, off + B.shape[0])
                bf[:, cols] = B.T * s
                return bf

            if section == "top":
                a_np = np.concatenate([A.T for (_, A, _, _, _) in rec["entries"]], axis=1)
                b_np = np.concatenate([b_full(A, B, s, off)
                                       for (_, A, B, s, off) in rec["entries"]], axis=0)
            else:
                by_layer: Dict[int, list] = {}
                for (layer, A, B, s, off) in rec["entries"]:
                    by_layer.setdefault(layer, []).append((A, B, s, off))
                rmax = max(sum(A.shape[0] for (A, _, _, _) in parts)
                           for parts in by_layer.values())
                a_np = np.zeros((n_layers[section], k, rmax), np.float32)
                b_np = np.zeros((n_layers[section], rmax, n), np.float32)
                for layer, parts in by_layer.items():
                    r0 = 0
                    for (A, B, s, off) in parts:
                        r = A.shape[0]
                        a_np[layer, :, r0:r0 + r] = A.T
                        b_np[layer, r0:r0 + r] = b_full(A, B, s, off)
                        r0 += r
            lin.lora = _merge_lora(lin.lora, torch.from_numpy(a_np).to(dev, dtype),
                                   torch.from_numpy(b_np).to(dev, dtype))
        else:
            lin.w = lin.w.clone()  # the tensor may be shared with another tree
            for (layer, A, B, s, off) in rec["entries"]:
                _fuse_dense(lin.w, None if section == "top" else layer, A, B, s, off)
    log.info("LoRA %s: applied %d factor pairs to %d linears", path, n_applied, len(physical))
    return params
