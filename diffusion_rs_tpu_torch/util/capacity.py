"""Static device-memory accounting (port of ``diffusion_rs_tpu/util/capacity.py``).

Weights' resident bytes, an estimate of what ISQ would leave, a rough
estimate of a denoise step's activations, and the check the pipeline runs
before it denoises: certain failure (the weights alone over the card's
memory) raises, an estimate over budget warns once. The loader's T5
capacity guard uses the same numbers.

The budget is the card's memory as torch reports it, or
DIFFUSION_RS_TPU_HBM_BYTES (the JAX package's name for the override). The
JAX package's 16 GiB default is a TPU's size and is not carried over: a
budget is asked for a CPU device only when the override is set.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..ops.linear import Linear, TensorParallel
from ..quant.qtensor import QuantizedTensor


def per_chip_hbm_bytes(device="cuda") -> int:
    """The memory budget of one device: DIFFUSION_RS_TPU_HBM_BYTES when set,
    else the CUDA card's total memory. Raises for a CPU device without the
    override."""
    env = os.environ.get("DIFFUSION_RS_TPU_HBM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no memory budget for device {dev}: set DIFFUSION_RS_TPU_HBM_BYTES")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def leaf_bytes_of(x) -> int:
    """Device bytes of one leaf: a dense tensor's bytes; a QuantizedTensor's
    packed residency (codes + f32 scale, bias and codebook)."""
    if isinstance(x, QuantizedTensor):
        b = x.packed.numel() * x.packed.element_size()
        b += x.scale.numel() * 4
        if x.bias is not None:
            b += x.bias.numel() * 4
        if x.codebook is not None:
            b += x.codebook.numel() * 4
        return b
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _leaves(tree):
    """Tensors and QuantizedTensors of a tree (Linear fields, LoRA terms and
    Conv fields included)."""
    if tree is None or isinstance(tree, TensorParallel):
        return
    if isinstance(tree, (torch.Tensor, QuantizedTensor)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):  # Linear, Conv
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def tree_device_bytes(params) -> int:
    """Total device bytes of a param tree (see :func:`leaf_bytes_of`)."""
    return sum(leaf_bytes_of(x) for x in _leaves(params))


def whole_tree_bytes(params) -> int:
    """:func:`tree_device_bytes` of the whole tree that ``params`` is one
    tensor-parallel rank's part of (parallel/sharding.py): each tensor a
    ``Linear``'s cut split counts tp times (a 4-bit codebook once). Equal to
    :func:`tree_device_bytes` for an uncut tree."""

    def visit(node) -> int:
        if isinstance(node, Linear) and node.tp is not None and node.tp.sharded:
            n, col = node.tp.size, node.tp.role == "col"
            w = node.w
            total = leaf_bytes_of(w) * n
            if isinstance(w, QuantizedTensor) and w.codebook is not None:
                total -= leaf_bytes_of(w.codebook) * (n - 1)
            total += leaf_bytes_of(node.b) * (n if col else 1)
            if node.lora is not None:
                a, bl = node.lora
                total += leaf_bytes_of(a) * (1 if col else n) + leaf_bytes_of(bl) * (n if col else 1)
            return total
        if isinstance(node, dict):
            return sum(visit(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(visit(v) for v in node)
        return sum(leaf_bytes_of(x) for x in _leaves(node))

    return visit(params)


# Bits per element of each ISQ target in the canonical layout (codes + f32
# scale per group, + f32 bias for the affine formats); for routing, never
# for allocation.
_ISQ_BITS = {
    "q8t": 8.0 + 32.0 / 256, "q8_0": 8.0 + 32.0 / 32,
    "nf4": 4.0 + 32.0 / 64, "fp4": 4.0 + 32.0 / 64,
    "q4_0": 4.0 + 32.0 / 32, "q4_1": 4.0 + 64.0 / 32,
    "q5_0": 5.0 + 32.0 / 32, "q5_1": 5.0 + 64.0 / 32,
    "q2_k": 2.0 + 32.0 / 16, "q3_k": 3.0 + 32.0 / 16,
    "q4_k": 4.0 + 64.0 / 32, "q5_k": 5.0 + 64.0 / 32,
    "q6_k": 6.0 + 32.0 / 16,
}


def estimate_isq_tree_bytes(params, target: str) -> int:
    """What a tree would occupy after ``isq_tree(params, target)``: Linear
    weights at least DIFFUSION_RS_TPU_ISQ_MIN (default 512) on both dims, as
    isq_tree's gate reads it, cost the target's bits per element
    (:data:`_ISQ_BITS`, 9 for an unknown target), everything else its
    present bytes."""
    min_features = int(os.environ.get("DIFFUSION_RS_TPU_ISQ_MIN", "512"))
    bits = _ISQ_BITS.get(target, 9.0)

    def visit(node) -> int:
        if isinstance(node, Linear):
            w = node.w
            k, n = w.shape[-2], w.shape[-1]
            planes = w.packed if isinstance(w, QuantizedTensor) else w
            stack = int(planes.shape[0]) if planes.dim() > 2 else 1
            if k >= min_features and n >= min_features:
                total = int(stack * k * n * bits / 8)
            else:
                total = leaf_bytes_of(w)
            return total + (0 if node.b is None else leaf_bytes_of(node.b))
        if isinstance(node, dict):
            return sum(visit(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(visit(v) for v in node)
        if hasattr(node, "__dataclass_fields__") and not isinstance(node, QuantizedTensor):
            return sum(visit(getattr(node, f)) for f in node.__dataclass_fields__)
        return leaf_bytes_of(node)

    return visit(params)


def estimate_denoise_activation_bytes(batch: int, img_tokens: int, txt_tokens: int,
                                      hidden: int, dtype_bytes: int = 2) -> int:
    """Rough peak activation residency of one denoise step: about 48 live
    [B, S, hidden] planes. The constant is the JAX package's, fitted on a
    TPU (v5e) and unverified on the H100; the port keeps it so that both
    packages warn alike, and chip_smoke.py prints the estimate beside each
    configuration's measured peak."""
    return batch * (img_tokens + txt_tokens) * hidden * dtype_bytes * 48


def check_denoise_capacity(flux_params, *, batch: int, img_tokens: int, txt_tokens: int,
                           hidden: int, tp: int = 1, device="cuda") -> Optional[str]:
    """Before a denoise: raise ValueError when the transformer's weights alone
    do not fit the device (certain), return a warning string when weights
    plus the activation estimate exceed it (the caller logs it once), else
    None.

    ``tp``: the tensor-parallel degree. The weights counted are the whole
    tree's bytes divided by tp (:func:`whole_tree_bytes`, from a rank's cut
    tree or a whole one), as the JAX package counts them, so that both
    packages warn at the same sizes. That figure undercounts what a rank
    holds by the leaves every rank keeps whole (the modulation linears, the
    norms): FLUX.1-dev in q8t at tp=2 counts about
    5.6 GiB against the 7.17 GiB a rank holds."""
    hbm = per_chip_hbm_bytes(device)
    w = whole_tree_bytes(flux_params) // max(1, tp)
    act = estimate_denoise_activation_bytes(batch, img_tokens, txt_tokens, hidden)
    if w >= hbm:
        raise ValueError(
            f"denoise: packed transformer weights alone are {w / 1e9:.1f} GB per "
            f"device vs {hbm / 1e9:.1f} GB — cannot fit on a single device. Route: "
            "load with a tensor-parallel mesh (Pipeline(mesh=make_mesh(tp=...)) cuts "
            "the planes), pick a smaller format (isq='nf4' halves q8t residency), or "
            "stream the blocks from host memory (Offloading.Stream).")
    if w + act > hbm:
        return (f"denoise: estimated residency {w / 1e9:.1f} GB weights"
                + (f" (tp={tp})" if tp > 1 else "")
                + f" + ~{act / 1e9:.1f} GB activations exceeds {hbm / 1e9:.1f} GB — "
                "likely out of memory. Routes: a tp mesh (weights / tp), an sp mesh "
                "(activations / sp), isq='nf4', a smaller batch or resolution.")
    return None
