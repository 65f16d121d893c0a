"""The work model of a FLUX.1 denoise step, from the configuration's shapes
alone: every linear's [M, K] x [K, N] product and every joint attention's
shape, with its operations, the bytes it must move and its roofline bound
max(operations / peak, bytes / bandwidth) at the published peaks
(``peaks.json``). The same arithmetic the port's kernel table used: each
input byte read once, each output byte written once, scale planes counted.

A roofline built on it reads the same work whatever kernel implements it."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

# bytes per weight element and per scale group, by format
_WEIGHT_BYTES = {"q8t": 1.0, "nf4": 0.5, "bfloat16": 2.0}
# the precision each format's product is computed in
COMPUTE = {"q8t": "int8", "nf4": "bfloat16", "bfloat16": "bfloat16"}


def _q8_group(k: int) -> int:
    g = min(256, k)
    while k % g:
        g //= 2
    return g


def _scale_groups(fmt: str, k: int) -> int:
    if fmt == "q8t":
        return k // _q8_group(k)
    if fmt == "nf4":
        return k // 64
    return 0


def runs_in_qmm(fmt: str, k: int, n: int) -> bool:
    """Whether the port's quantized-matmul kernels tile this product (the
    rest take a dequantize and a dense product): N a multiple of 128 and K of
    the kernels' K-tile."""
    if fmt not in ("q8t", "nf4"):
        return False
    bk = min(256, k) if fmt == "q8t" else (256 if k % 256 == 0 else 64)
    return n % 128 == 0 and k % bk == 0 and bk % 8 == 0


def linear_work(m: int, k: int, n: int, fmt: str) -> dict:
    ops = 2.0 * m * k * n
    byts = 2.0 * m * k + _WEIGHT_BYTES[fmt] * k * n + 4.0 * _scale_groups(fmt, k) * n \
        + 2.0 * m * n
    peak = PEAKS["ops_per_s"][COMPUTE[fmt]]
    return {"ops": ops, "bytes": byts, "peak_s": ops / peak,
            "bound_s": max(ops / peak, byts / PEAKS["bytes_per_s"])}


def attention_work(b: int, h: int, s: int, d: int) -> dict:
    ops = 4.0 * b * h * s * s * d
    byts = 4.0 * b * h * s * d * 2.0  # q, k, v in, o out, bfloat16
    peak = PEAKS["ops_per_s"]["bfloat16"]
    return {"ops": ops, "bytes": byts, "peak_s": ops / peak,
            "bound_s": max(ops / peak, byts / PEAKS["bytes_per_s"])}


def linears(cfg: dict, batch: int, height: int, width: int):
    """(name, M, K, N, format, calls) of one step's linears."""
    fmt = cfg["formats"]["flux_linears"]
    h = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    m = int(h * cfg.get("mlp_ratio", 4.0))
    s_img = ((height + 15) // 16) * ((width + 15) // 16) * batch
    s_txt = cfg["generation"]["max_sequence_length"] * batch
    L, S = cfg["num_layers"], cfg["num_single_layers"]
    out = [("img_in", s_img, cfg["in_channels"], h, fmt, 1),
           ("txt_in", s_txt, cfg["joint_attention_dim"], h, fmt, 1),
           ("time_in.in", batch, 256, h, fmt, 1), ("time_in.out", batch, h, h, fmt, 1),
           ("vector_in.in", batch, cfg["pooled_projection_dim"], h, fmt, 1),
           ("vector_in.out", batch, h, h, fmt, 1)]
    if cfg["guidance_embeds"]:
        out += [("guidance_in.in", batch, 256, h, fmt, 1),
                ("guidance_in.out", batch, h, h, fmt, 1)]
    for stream, rows in (("img", s_img), ("txt", s_txt)):
        out += [(f"double.{stream}_mod", batch, h, 6 * h, fmt, L),
                (f"double.{stream}_attn.qkv", rows, h, h, fmt, 3 * L),
                (f"double.{stream}_attn.proj", rows, h, h, fmt, L),
                (f"double.{stream}_mlp.in", rows, h, m, fmt, L),
                (f"double.{stream}_mlp.out", rows, m, h, fmt, L)]
    rows = s_img + s_txt
    out += [("single.mod", batch, h, 3 * h, fmt, S), ("single.qkv", rows, h, h, fmt, 3 * S),
            ("single.proj_mlp", rows, h, m, fmt, S), ("single.linear2", rows, h + m, h, fmt, S),
            ("final.mod", batch, h, 2 * h, fmt, 1),
            ("final.proj", s_img, h, cfg["in_channels"], fmt, 1)]
    return out


def step(cfg: dict, batch: int, height: int, width: int) -> dict:
    """One denoise step's work: per family (``qmm``: the linears the
    quantized kernels tile; ``attn``: joint attention) the summed bound, and
    for the whole step the time at the published peaks (``peak_s``)."""
    lin = [(linear_work(mm, k, n, f), c, runs_in_qmm(f, k, n))
           for _, mm, k, n, f, c in linears(cfg, batch, height, width)]
    s = (((height + 15) // 16) * ((width + 15) // 16)
         + cfg["generation"]["max_sequence_length"])
    heads, d = cfg["num_attention_heads"], cfg["attention_head_dim"]
    att = attention_work(batch, heads, s, d)
    n_att = cfg["num_layers"] + cfg["num_single_layers"]
    return {
        "qmm": {"bound_s": sum(w["bound_s"] * c for w, c, q in lin if q),
                "ops": sum(w["ops"] * c for w, c, q in lin if q)},
        "linears": {"ops": sum(w["ops"] * c for w, c, _ in lin),
                    "peak_s": sum(w["peak_s"] * c for w, c, _ in lin)},
        "attn": {"bound_s": att["bound_s"] * n_att, "ops": att["ops"] * n_att,
                 "peak_s": att["peak_s"] * n_att},
        "peak_s": sum(w["peak_s"] * c for w, c, _ in lin) + att["peak_s"] * n_att,
    }
