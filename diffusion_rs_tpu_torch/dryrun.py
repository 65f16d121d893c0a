"""The training dryrun (port of ``__graft_entry__.py``).

* :func:`entry` -> ``(fn, example_args)``: the single-card FLUX denoise
  step on the tiny config, bf16, batch 1, 64 text + 256 image tokens.
* :func:`dryrun_multichip` ``(n)``: an n-rank (dp, sp, tp) mesh with JAX's
  rule (dp = sp = 2 when 8 divides n, dp = 2 when 4 does, tp the rest; heads
  tp x (2 if tp <= 4 else 1)), then two phases, one printed line each:

  1. dense f32 training: params cut over tp, the batch of 2 dp split over
     dp and its image tokens over sp, the flow-match loss
     ``mean((pred - target)^2)`` over the whole batch, ``loss.backward()``
     through the differentiable collectives (parallel/mesh.py), gradients
     summed over dp and sp, SGD at 1e-4, then one no-grad inference step on
     the updated params. Attention runs ``sdpa_xla`` (the phase sets
     DIFFUSION_RS_TPU_NO_FLASH, as JAX's CPU mesh runs its XLA path): the
     hand-written kernels have no backward, and ``_cuda.launch`` refuses an
     operand that requires grad, so the step launches none;
  2. q8t + sp inference: q8t params (util/synthetic) cut over tp, the image
     over (dp, sp), every joint attention a ring through K14 when sp > 1;
     JAX asserts a collective-permute in the HLO, the port counts the
     ring's hops (ops/partitioned.RING_HOPS) and, on the card, K1 and K14
     launches.

Run it as ``python -m diffusion_rs_tpu_torch.dryrun`` (n from
DRYRUN_DEVICES, default 8: the ranks are spawned on this host and share its
cards, gloo where they outnumber them) or under ``torchrun`` (n is the
world size). It runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .models.flux import FluxConfig, compute_pe, flux_forward
from .ops import _cuda, attention
from .ops.partitioned import RING_HOPS
from .parallel import launch
from .parallel.mesh import (Mesh, all_reduce_sum, batch_sharding, make_mesh,
                            sequence_sharding)
from .parallel.sharding import shard_params
from .pipelines.sampling import make_img_ids, make_txt_ids
from .util.device import resolve_device
from .util.synthetic import init_flux_params, init_flux_params_quantized
from .util.tree import tree_leaves, tree_map

LR = 1e-4
DT_SIGMA = -1.0 / 28


def tiny_cfg(heads: int = 4) -> FluxConfig:
    """JAX's ``_tiny_cfg``: 2 double + 4 single blocks, head dim 32."""
    return FluxConfig(in_channels=64, pooled_projection_dim=64, joint_attention_dim=64,
                      num_attention_heads=heads, num_layers=2, num_single_layers=4,
                      guidance_embeds=True, hidden_size=heads * 32, axes_dim=(8, 12, 12))


def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normal drawn on the host from ``gen`` (the same values on
    every rank and device), then moved."""
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device, dtype)


def entry(device="cuda"):
    """The single-card denoise step ``fn(params, img, txt, y, t, guidance,
    dt_sigma) -> img + pred * dt_sigma`` (f32, as JAX promotes it) and its
    example args: tiny-config bf16 params from seed 0, inputs from a
    generator seeded 1, t 0.7, guidance 3.5, dt -1/28."""
    dev = resolve_device(device)
    cfg = tiny_cfg()
    dtype = torch.bfloat16
    params = init_flux_params(0, cfg, dtype, device=dev)
    b, txt_len, h2, w2 = 1, 64, 16, 16
    gen = torch.Generator().manual_seed(1)
    img = _normal(gen, (b, h2 * w2, cfg.in_channels), dtype, dev)
    txt = _normal(gen, (b, txt_len, cfg.joint_attention_dim), dtype, dev)
    y = _normal(gen, (b, cfg.pooled_projection_dim), dtype, dev)
    pe = compute_pe(cfg, make_txt_ids(b, txt_len, dev), make_img_ids(b, h2, w2, dev))

    @torch.no_grad()
    def step(params, img, txt, y, t, guidance, dt_sigma):
        pred = flux_forward(params, cfg, img, txt, t, y, guidance, pe=pe)
        return img.float() + pred.float() * dt_sigma

    t = torch.full((b,), 0.7, dtype=torch.float32, device=dev)
    guidance = torch.full((b,), 3.5, dtype=torch.float32, device=dev)
    dt_sigma = torch.tensor(DT_SIGMA, dtype=torch.float32, device=dev)
    return step, (params, img, txt, y, t, guidance, dt_sigma)


def mesh_axes(n: int) -> Tuple[int, int, int, int]:
    """(dp, sp, tp, heads) of JAX's dryrun for ``n`` ranks."""
    if n % 8 == 0:
        dp, sp = 2, 2
    elif n % 4 == 0:
        dp, sp = 2, 1
    else:
        dp, sp = 1, 1
    tp = n // (dp * sp)
    return dp, sp, tp, tp * (2 if tp <= 4 else 1)


def make_batch(cfg: FluxConfig, b: int, device) -> Dict[str, torch.Tensor]:
    """The dryrun's whole f32 batch of ``b``, 16 text and 8x8 image tokens
    (JAX's): img / txt / y from a generator seeded 1, the flow-match target
    from one seeded 7, t 0.7, guidance 3.5, and the position ids."""
    txt_len, h2, w2 = 16, 8, 8
    gen = torch.Generator().manual_seed(1)
    f32 = torch.float32
    batch = {"img": _normal(gen, (b, h2 * w2, cfg.in_channels), f32, device),
             "txt": _normal(gen, (b, txt_len, cfg.joint_attention_dim), f32, device),
             "y": _normal(gen, (b, cfg.pooled_projection_dim), f32, device)}
    batch["target"] = _normal(torch.Generator().manual_seed(7), batch["img"].shape, f32, device)
    batch["t"] = torch.full((b,), 0.7, dtype=f32, device=device)
    batch["guidance"] = torch.full((b,), 3.5, dtype=f32, device=device)
    batch["txt_ids"] = make_txt_ids(b, txt_len, device)
    batch["img_ids"] = make_img_ids(b, h2, w2, device)
    return batch


def _local_inputs(batch: Dict[str, torch.Tensor], mesh: Mesh, cfg: FluxConfig):
    """This rank's rows: the batch over dp, the image tokens (and target)
    over sp; the RoPE tables of its dp rows' whole sequence."""
    rows, seq = batch_sharding(mesh), sequence_sharding(mesh)
    local = {k: rows.local(batch[k]) for k in ("txt", "y", "t", "guidance", "txt_ids",
                                               "img_ids")}
    local["img"], local["target"] = seq.local(batch["img"]), seq.local(batch["target"])
    local["pe"] = compute_pe(cfg, local.pop("txt_ids"), local.pop("img_ids"))
    return local


def _predict(params, cfg: FluxConfig, x: Dict[str, torch.Tensor], img: torch.Tensor,
             mesh: Mesh) -> torch.Tensor:
    return flux_forward(params, cfg, img, x["txt"].to(img.dtype), x["t"], x["y"].to(img.dtype),
                        x["guidance"], pe=x["pe"], mesh=mesh)


def _sum_over_dp_sp(ts, mesh: Mesh):
    """Every tensor of ``ts`` summed over the mesh's dp and sp axes, in one
    flattened all-reduce per axis."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    for axis in ("dp", "sp"):
        flat = all_reduce_sum(flat, mesh.groups[axis])
    return list(torch.split(flat, [t.numel() for t in ts]))


@contextlib.contextmanager
def xla_attention():
    """DIFFUSION_RS_TPU_NO_FLASH=1 for the block (attention through
    ``sdpa_xla``), the knob's cache cleared on entry and on exit."""
    prev = os.environ.get("DIFFUSION_RS_TPU_NO_FLASH")
    os.environ["DIFFUSION_RS_TPU_NO_FLASH"] = "1"
    attention._no_flash.cache_clear()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("DIFFUSION_RS_TPU_NO_FLASH", None)
        else:
            os.environ["DIFFUSION_RS_TPU_NO_FLASH"] = prev
        attention._no_flash.cache_clear()


def train_step(params, batch: Dict[str, torch.Tensor], mesh: Mesh, cfg: FluxConfig):
    """One flow-match SGD step (learning rate :data:`LR`) on this rank's cut
    of ``params`` (dense, f32) over the whole ``batch`` (:func:`make_batch`'s
    keys), of which it takes its rows. Returns ``(loss, grads, new_params)``: the global loss (every
    rank the same value), this rank's gradient tree (each leaf's gradient
    summed over dp and sp; a leaf cut over tp keeps its own shard's) and the
    updated tree. The loss is ``mean((pred - target)^2)`` over the global
    batch and every token: each rank sums its own squared errors over the
    global count. Runs attention through ``sdpa_xla``
    (DIFFUSION_RS_TPU_NO_FLASH for the step's duration)."""
    x = _local_inputs(batch, mesh, cfg)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with xla_attention(), torch.enable_grad():
        pred = _predict(leaves, cfg, x, x["img"], mesh)
        local = ((pred.float() - x["target"]) ** 2).sum() / batch["target"].numel()
        local.backward()
    grads_local = tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
                           leaves)
    it = iter(_sum_over_dp_sp(tree_leaves(grads_local), mesh))
    grads = tree_map(lambda t: next(it).view_as(t), grads_local)
    (loss,) = _sum_over_dp_sp([local.detach().reshape(1)], mesh)
    g_it = iter(tree_leaves(grads))
    new_params = tree_map(lambda p: (p - LR * next(g_it)).detach(), params)
    return loss[0], grads, new_params


def _tp_cut_grads(grads):
    """(name, gradient) of every Linear leaf cut over tp, in tree order."""
    from .ops.linear import Linear

    out = []

    def visit(node, name):
        if isinstance(node, Linear):
            if node.tp is not None and node.tp.size > 1 and node.tp.sharded:
                out.append((f"{name}.w", node.w))
                if node.b is not None and node.tp.role == "col":
                    out.append((f"{name}.b", node.b))
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{name}.{k}" if name else k)

    visit(grads, "")
    return out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _run(mesh: Mesh, heads: int, verbose: bool) -> dict:
    """Both phases on this rank; returns its record. Raises
    ``RuntimeError`` when a check of either phase fails."""
    dp, sp, tp = (mesh.shape[a] for a in ("dp", "sp", "tp"))
    dev = mesh.device
    cfg = tiny_cfg(heads)
    b = 2 * dp
    rec = {"mesh": (dp, sp, tp), "heads": heads, "batch": b}

    # phase 1: dense f32 training (the launch counts must not move)
    params = shard_params(init_flux_params(0, cfg, torch.float32, device=dev), mesh)
    batch = make_batch(cfg, b, dev)
    before = _cuda.launch_counts()
    loss, grads, new_params = train_step(params, batch, mesh, cfg)
    rec["train_launches"] = {k: v - before[k] for k, v in _cuda.launch_counts().items()
                             if v != before[k]}
    _check(not rec["train_launches"], f"the training step launched {rec['train_launches']}")
    rec["loss"] = float(loss)
    _check(bool(torch.isfinite(loss)), f"loss {rec['loss']}")
    cut = _tp_cut_grads(grads)
    rec["tp_cut_leaves"] = len(cut)
    rec["zero_grad_leaves"] = [n for n, g in cut if not bool(g.abs().sum() > 0)]
    _check(not rec["zero_grad_leaves"], f"zero gradients: {rec['zero_grad_leaves']}")
    x = _local_inputs(batch, mesh, cfg)
    with xla_attention(), torch.no_grad():  # the f32 step, as phase 1's JAX step
        out = x["img"] + _predict(new_params, cfg, x, x["img"], mesh) * DT_SIGMA
    _check(out.shape == x["img"].shape and bool(torch.isfinite(out).all()),
           f"phase 1's inference step: {tuple(out.shape)}, not finite or not the input's shape")
    qw = new_params["double"]["img_attn"]["q"]
    rec["out_block"] = tuple(out.shape)
    if verbose:
        cut_txt = (f"cut over tp ({tuple(qw.w.shape)} of {cfg.hidden_size} columns)"
                   if qw.tp is not None else "whole")
        print(f"dryrun_multichip OK: mesh dp={dp} sp={sp} tp={tp}, batch {b}, "
              f"loss {rec['loss']:.4f}, q.w {cut_txt}, out (dp, sp) block "
              f"{tuple(out.shape)}", flush=True)

    # phase 2: q8t + sp inference, the ring through K14 when sp > 1
    dtype = torch.bfloat16
    qparams = shard_params(init_flux_params_quantized(2, cfg, dtype, kind="q8t", device=dev),
                           mesh)
    before, hops = _cuda.launch_counts(), RING_HOPS["hops"]
    with torch.no_grad():
        img = x["img"].to(dtype)
        qout = img.float() + _predict(qparams, cfg, x, img, mesh).float() * DT_SIGMA
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec["q8t_launches"] = {k: v - before[k] for k, v in _cuda.launch_counts().items()
                           if v != before[k]}
    rec["ring_hops"] = RING_HOPS["hops"] - hops
    _check(qout.shape == x["img"].shape and bool(torch.isfinite(qout).all()),
           f"phase 2's step: {tuple(qout.shape)}, not finite or not the input's shape")
    joint = cfg.num_layers + cfg.num_single_layers
    if sp > 1:
        _check(rec["ring_hops"] == joint * (sp - 1),
               f"sp-sharded joint attention must run as the ring: {rec['ring_hops']} hops, "
               f"expected {joint * (sp - 1)}")
        if dev.type == "cuda":
            _check(rec["q8t_launches"].get("flash_fwd_lse", 0) > 0,
                   f"the ring launched no K14: {rec['q8t_launches']}")
    if dev.type == "cuda":
        _check(rec["q8t_launches"].get("qmm_s8", 0) > 0,
               f"the q8t step launched no K1: {rec['q8t_launches']}")
    plane = qparams["double"]["img_mlp"]["out"]
    rec["q8t_plane"] = tuple(plane.w.packed.shape)
    if verbose:
        k_cut = (f"K-cut over tp ({plane.w.packed.shape[-2]} of {cfg.mlp_size} rows)"
                 if plane.tp is not None and plane.tp.sharded else "whole")
        ring = (f"ring ({rec['ring_hops']} hops"
                + (f", {rec['q8t_launches'].get('flash_fwd_lse', 0)} K14 launches)"
                   if dev.type == "cuda" else ")") if sp > 1 else "n/a (sp=1)")
        print(f"dryrun_multichip quantized+sp OK: q8t packed plane img_mlp.out {k_cut}, "
              f"ring={ring}, out (dp, sp) block {tuple(qout.shape)}", flush=True)
    return rec


def dryrun_multichip(n_devices: int, device="cuda") -> Optional[dict]:
    """The dryrun on ``n_devices`` ranks. On the current process group when
    one of that size exists (every rank calls it; returns this rank's
    record), else on ``n_devices`` ranks spawned on this host
    (parallel.spawn; returns None, rank 0 prints)."""
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        dp, sp, tp, heads = mesh_axes(n_devices)
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device=device)
        return _run(mesh, heads, verbose=dist.get_rank() == 0)
    if n_devices == 1:
        mesh = make_mesh(device=device)
        return _run(mesh, mesh_axes(1)[3], verbose=True)
    if torch.device(device).type == "cuda":
        resolve_device(device)  # raises without CUDA
    backend = "gloo" if torch.device(device).type == "cpu" else None
    launch.spawn(_spawned, n_devices, backend, args=(n_devices, str(torch.device(device))))
    return None


def _spawned(rank: int, n_devices: int, device: str) -> None:
    dryrun_multichip(n_devices, device)


if __name__ == "__main__":
    from .parallel.multihost import init_multihost

    if init_multihost():
        dryrun_multichip(dist.get_world_size())
    else:
        dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", "8")))
