"""Plain float32 building blocks of the reference: its own dequantization of
the raw planes, the matmul and attention it runs (TF32 off), and the
precision it computes them in (``Precision``: float32, or one step below the
configuration's for the control). Nothing here imports the program."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark.harness.planes import NF4, Q8, Cv, Lin


def dequant(w, i=None) -> torch.Tensor:
    """f32 ``[K, N]`` of a weight (dense, Q8 or NF4), layer ``i`` of a stack."""
    if isinstance(w, Q8):
        codes, scale = (w.codes, w.scale) if i is None else (w.codes[i], w.scale[i])
        k, n = codes.shape
        g = w.group
        return (codes.float().view(k // g, g, n) * scale.view(k // g, 1, n)).view(k, n)
    if isinstance(w, NF4):
        packed, scale = (w.packed, w.scale) if i is None else (w.packed[i], w.scale[i])
        cb = w.codebook if w.codebook.dim() == 1 else w.codebook[i]
        k2, n = packed.shape
        k, s = 2 * k2, w.split
        p = packed.view(k // s, s // 2, n)
        codes = torch.cat([p & 0xF, p >> 4], dim=1).view(k, n)
        vals = cb.float()[codes.long()]
        g = w.group
        return (vals.view(k // g, g, n) * scale.view(k // g, 1, n)).view(k, n)
    return (w if i is None else w[i]).float()


def take(t, i):
    return None if t is None else (t if i is None else t[i])


class Precision:
    """How the reference rounds what it computes.

    ``"float32"``: not at all (the reference). The controls sit one step
    below the bfloat16 that the configurations state for their activations,
    float8 e4m3, per row (per pixel over the channels for a convolution):

    - ``"fp8_products"``: the inputs of every product (each linear, QK^T
      and P.V, each convolution) in float8, and everything else (the norms,
      the residual streams, the f32 accumulation) as the reference keeps it:
      the shortcut that a faster kernel would take on an H100's float8 tensor
      cores (for q8t linears in place of the int8 activation rows);
    - ``"fp8_activations"``: every activation that the configuration keeps in
      bfloat16 in float8: the products' inputs and outputs, the norms'
      outputs and the residual streams (``store``)."""

    MODES = ("float32", "fp8_products", "fp8_activations")

    def __init__(self, mode: str = "float32"):
        if mode not in self.MODES:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def product_in(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product (rows over the last dim)."""
        return x if self.mode == "float32" else fp8_rows(x)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the precision keeps it (rows over the last dim)."""
        return fp8_rows(x) if self.mode == "fp8_activations" else x

    def product_in_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mode == "float32" else _nchw(fp8_rows, x)

    def store_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(fp8_rows, x) if self.mode == "fp8_activations" else x


def _nchw(f, x: torch.Tensor) -> torch.Tensor:
    return f(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 round trip per row (scaled so that the row's max is 448)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, lin: Lin, prec: Precision, i=None) -> torch.Tensor:
    """``x @ deq(w) + b`` in f32."""
    y = prec.product_in(x) @ dequant(lin.w, i)
    b = take(lin.b, i)
    return prec.store(y if b is None else y + b.float())


def attention(q, k, v, prec: Precision, scale=None, bias=None, q_block: int = 1024):
    """Softmax attention over [B, H, S, D] in f32, query rows in blocks."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    q, k, v = prec.product_in(q), prec.product_in(k), prec.product_in(v)
    out = torch.empty_like(q)
    for s0 in range(0, q.shape[2], q_block):
        sc = (q[:, :, s0:s0 + q_block] @ k.transpose(-1, -2)) * scale
        if bias is not None:
            sc = sc + bias[:, :, s0:s0 + q_block]
        out[:, :, s0:s0 + q_block] = prec.product_in(torch.softmax(sc, dim=-1)) @ v
    return prec.store(out)


def layer_norm(x, w=None, b=None, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], None if w is None else w.float(),
                        None if b is None else b.float(), eps)


def rms_norm(x, w, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def conv(x_nchw: torch.Tensor, c: Cv, prec: Precision, stride=1, padding=0) -> torch.Tensor:
    w = c.w.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    return prec.store_nchw(F.conv2d(prec.product_in_nchw(x_nchw), w,
                                    None if c.b is None else c.b.float(), stride, padding))


@contextlib.contextmanager
def strict_float32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])
