"""Helpers for the parity tests between the JAX package and its PyTorch port.

The tests make their inputs with numpy, run them through both packages and
compare. JAX params cross over as plain Python + numpy (``to_numpy_tree``),
which the port's bridge turns into its own params.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops.conv import Conv as JConv
from diffusion_rs_tpu.ops.linear import Linear as JLinear
from diffusion_rs_tpu.quant.qtensor import QuantizedTensor as JQT
from diffusion_rs_tpu_torch.bridge import from_numpy_tree


def summed_rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-9))


def to_numpy_tree(tree):
    """JAX param pytree -> the bridge's plain form (module doc of
    diffusion_rs_tpu_torch/bridge.py)."""
    if tree is None:
        return None
    if isinstance(tree, JLinear):
        return {"__type__": "Linear", "w": to_numpy_tree(tree.w),
                "b": to_numpy_tree(tree.b),
                "lora": None if tree.lora is None else [to_numpy_tree(t) for t in tree.lora]}
    if isinstance(tree, JConv):
        return {"__type__": "Conv", "w": to_numpy_tree(tree.w), "b": to_numpy_tree(tree.b)}
    if isinstance(tree, JQT):
        return {"__type__": "QuantizedTensor",
                "packed": np.asarray(tree.packed), "scale": np.asarray(tree.scale),
                "bias": to_numpy_tree(tree.bias), "codebook": to_numpy_tree(tree.codebook),
                "kind": tree.kind, "bits": tree.bits, "group": tree.group,
                "split": tree.split, "shape": tuple(tree.shape),
                "out_dtype": tree.out_dtype}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def to_jax_tree(tree):
    """The port's dense params (f32 tensors, ``Linear``, ``Conv``) -> the JAX
    package's: the reverse of the bridge, for params the port's fast
    synthetic factories made."""
    from diffusion_rs_tpu_torch.ops.conv import Conv as TConv
    from diffusion_rs_tpu_torch.ops.linear import Linear as TLinear

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.detach().cpu().numpy())
    if isinstance(tree, TLinear):
        return JLinear(w=to_jax_tree(tree.w), b=to_jax_tree(tree.b))
    if isinstance(tree, TConv):
        return JConv(w=to_jax_tree(tree.w), b=to_jax_tree(tree.b))
    if isinstance(tree, dict):
        return {k: to_jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax_tree(v) for v in tree)
    raise TypeError(f"unexpected leaf {type(tree)}")


def quantize_tree(params, quantize, dtype):
    """Quantize every 2-D/stacked-3-D Linear weight; other leaves -> dtype.
    Biases become small random values so the bias add is exercised."""
    rng = np.random.default_rng(1)

    def leaf(x):
        if isinstance(x, JLinear):
            w = np.asarray(x.w, np.float32)
            if w.ndim == 2:
                qw = quantize(w)
            else:
                qws = [quantize(w[i]) for i in range(w.shape[0])]
                qw = jax.tree.map(lambda *xs: jnp.stack(xs), *qws)
            b = None if x.b is None else jnp.asarray(
                rng.standard_normal(x.b.shape) * 0.02, dtype)
            return JLinear(w=qw, b=b)
        return jnp.asarray(x, dtype)

    return jax.tree.map(leaf, params, is_leaf=lambda x: isinstance(x, JLinear))


def port_params(jax_tree, device="cpu"):
    return from_numpy_tree(to_numpy_tree(jax_tree), device)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU (the
    port's CPU path follows the same kernel math)."""
    attention = importlib.import_module("diffusion_rs_tpu.ops.attention")
    linear = importlib.import_module("diffusion_rs_tpu.ops.linear")

    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM", "interpret")
    monkeypatch.setenv("DIFFUSION_RS_TPU_FLASH", "interpret")
    linear._qmm_mode.cache_clear()
    attention._flash_mode.cache_clear()
    yield
    monkeypatch.undo()
    linear._qmm_mode.cache_clear()
    attention._flash_mode.cache_clear()
