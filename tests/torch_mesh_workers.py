"""Rank functions for the port's multi-process tests.

``parallel.spawn`` runs each in a fresh process per rank, which imports this
module by name: it imports torch and the port only, never jax or the JAX
package. Inputs and outputs cross as ``.npy`` / ``.npz`` / pickle files in
the test's temporary directory; the JAX side of each comparison runs in the
pytest process.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np
import torch

from diffusion_rs_tpu_torch.bridge import from_numpy_tree
from diffusion_rs_tpu_torch.ops import partitioned
from diffusion_rs_tpu_torch.parallel import make_mesh, sequence_sharding
from diffusion_rs_tpu_torch.util.tree import tree_leaves

RING_MODES = {"bf16": (False, False), "s8": (True, False), "s8_pv": (False, True)}
WARN_TEXT = "REPLICATING the sequence per shard"


class _Warnings(logging.Handler):
    """Collects the port's WARNING messages."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []
        logging.getLogger("diffusion_rs_tpu_torch").addHandler(self)

    def emit(self, record):
        self.messages.append(record.getMessage())


def _count_rings():
    """Wrap ops.partitioned.ring_attention with a call counter."""
    calls = [0]
    ring = partitioned.ring_attention

    def counted(*a, **kw):
        calls[0] += 1
        return ring(*a, **kw)

    partitioned.ring_attention = counted
    return calls


def ring_rank(rank: int, tmp: str, stems=("inputs",)) -> None:
    """For each ``stem``, ``tmp/<stem>.npz`` holds q/k/v [B, H, S, D] per
    case (``<case>_q``, ...) and the runs ``<case>:<mode>``; each rank takes
    its rows, ``tensor_split``-even or cut by ``lens`` (uneven: the gather
    fallback), and runs :func:`partitioned.partitioned_flash` for each run.
    Saves each run's local output and whether the fallback warning was
    logged to ``tmp/ring_<stem>_<rank>.npz``."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    tmp = Path(tmp)
    world = dist.get_world_size()
    warned = _Warnings()
    for stem in stems:
        inp = np.load(tmp / f"{stem}.npz")
        runs = [str(r) for r in inp["runs"]]
        s = inp[runs[0].split(":")[0] + "_q"].shape[2]
        lens = [int(n) for n in inp["lens"]] if "lens" in inp else [s // world] * world
        cut = np.cumsum([0] + lens)
        seq = partitioned.SeqShard(dist.group.WORLD, lens)
        warned.messages.clear()
        out = {}
        for run in runs:
            case, mode = run.split(":")
            s8, s8_pv = RING_MODES[mode]
            q, k, v = (torch.from_numpy(inp[f"{case}_{t}"][:, :, cut[rank]:cut[rank + 1]])
                       for t in "qkv")
            out[run] = partitioned.partitioned_flash(q, k, v, seq, s8=s8, s8_pv=s8_pv).numpy()
        out["warned"] = np.array(any(WARN_TEXT in m for m in warned.messages))
        np.savez(tmp / f"ring_{stem}_{rank}.npz", **out)


def _digest(tree) -> np.ndarray:
    """Each tensor's size and sum of magnitudes, sorted (the two packages'
    trees order their keys differently)."""
    return np.array(sorted((t.numel(), float(t.double().abs().sum()))
                           for t in tree_leaves(tree)))


def flux_rank(rank: int, tmp: str) -> None:
    """The tiny FLUX forward at dp=2 sp=2 (world 4): params bridged from the
    JAX package's, each rank its dp rows of the batch and its sp rows of the
    image tokens, the whole output gathered on every rank. Runs the default
    layout and the fused-RoPE one (params re-laid half-split)."""
    import dataclasses

    from diffusion_rs_tpu_torch.models.flux import FluxConfig, compute_pe, flux_forward
    from diffusion_rs_tpu_torch.models.optimize import rope_halfsplit_permute
    from diffusion_rs_tpu_torch.parallel import batch_sharding

    torch.set_num_threads(2)
    tmp = Path(tmp)
    with open(tmp / "flux.pkl", "rb") as f:
        blob = pickle.load(f)
    cfg = FluxConfig(**blob["cfg"])
    params = from_numpy_tree(blob["params"], "cpu")
    mesh = make_mesh(dp=2, sp=2, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in np.load(tmp / "flux_inputs.npz").items()}
    rows = batch_sharding(mesh)
    img = sequence_sharding(mesh).local(inp["img"])
    txt, t, y, txt_ids, img_ids = (rows.local(inp[k]) for k in
                                   ("txt", "t", "y", "txt_ids", "img_ids"))
    pe = compute_pe(cfg, txt_ids, img_ids)
    calls = _count_rings()
    out = {"digest": _digest(params)}
    for name, (p, c) in {"default": (params, cfg),
                         "fused_rope": (rope_halfsplit_permute(params, cfg),
                                        dataclasses.replace(cfg, rope_fused=True))}.items():
        before = calls[0]
        o = flux_forward(p, c, img, txt, t, y, None, pe=pe, mesh=mesh)
        out[name] = sequence_sharding(mesh).gather(o, (inp["img"].shape[0], inp["img"].shape[1],
                                                       o.shape[2])).numpy()
        out[f"{name}_rings"] = np.array(calls[0] - before)
    np.savez(tmp / f"flux_{rank}.npz", **out)


def pipeline_rank(rank: int, tmp: str) -> None:
    """``Pipeline(mesh=make_mesh(dp=2, sp=2))`` from the tiny checkpoint at
    ``tmp/ckpt``, with the JAX package's noise for the seed: the images and
    the latents of two prompts (one per dp rank), every rank's weight
    digest, its ring calls and warnings; the same images under the mesh with
    ``Offloading.Full``; then ``fuse="grouped"`` under the mesh (turned off,
    with JAX's warning); then the images and latents of
    ``Pipeline(mesh=make_mesh(dp=2, tp=2))``, its img2img and inpaint
    latents, and its images with ``Offloading.Full``."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.pipelines import flux_pipeline
    from diffusion_rs_tpu_torch.pipelines.api import ModelSource, Offloading, Pipeline

    torch.set_num_threads(2)
    tmp = Path(tmp)
    noise = torch.from_numpy(np.load(tmp / "noise.npy"))
    flux_pipeline.get_noise = lambda seed, n, h, w, device: noise.clone()
    with open(tmp / "gen.pkl", "rb") as f:
        gen, prompts = pickle.load(f)
    warned = _Warnings()
    mesh = make_mesh(dp=2, sp=2, device="cpu")
    pipe = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, mesh=mesh,
                    device="cpu")
    calls = _count_rings()
    params = DiffusionGenerationParams(**gen)
    images = np.stack(pipe.forward_images(prompts, params))
    rings = calls[0]
    latents = pipe.forward_latents(prompts, params)
    full = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, mesh=mesh,
                    device="cpu", offloading=Offloading.Full)
    full_images = np.stack(full.forward_images(prompts, params))
    grouped = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, mesh=mesh,
                       device="cpu", fuse="grouped")._inner
    img2img_rank(rank, tmp, pipe, gen, prompts)
    tp_mesh = make_mesh(dp=2, tp=2, device="cpu")
    tp = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, mesh=tp_mesh,
                  device="cpu")
    img2img_rank(rank, tmp, tp, gen, prompts, stem="i2i_tp")
    tp_full = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, mesh=tp_mesh,
                       device="cpu", offloading=Offloading.Full)
    np.savez(tmp / f"pipe_{rank}.npz", images=images, latents=latents, rings=np.array(rings),
             full_images=full_images,
             full_released=np.array(not full._inner.offload._refs
                                    and full._inner.offload.manages("flux")),
             digest=_digest(pipe._inner.flux_params),
             fallback=np.array(any(WARN_TEXT in m for m in warned.messages)),
             grouped_qmm=np.array(grouped.flux_cfg.grouped_qmm),
             grouped_fused="qkv" in grouped.flux_params["double"]["img_attn"],
             grouped_warned=np.array(any("fuse='grouped' has no mesh partitioning rule" in m
                                         for m in warned.messages)),
             tp_images=np.stack(tp.forward_images(prompts, params)),
             tp_latents=tp.forward_latents(prompts, params),
             tp_cut=np.array(tp._inner.flux_params["double"]["img_attn"]["q"].w.shape),
             tp_full_images=np.stack(tp_full.forward_images(prompts, params)),
             tp_full_cut=np.array(tp_full._inner.offload.resident("flux")["double"]["img_attn"]
                                  ["q"].w.shape))


def img2img_rank(rank: int, tmp: Path, pipe, gen: dict, prompts, stem: str = "i2i") -> None:
    """img2img (strength 0.5) and inpaint (0.75) through ``pipe`` (under the
    mesh) on ``tmp/i2i.npz``'s init images and latent-size mask, with the
    port's own encoder sample for the seed: saves the packed latents of both
    to ``tmp/<stem>_<rank>.npz``."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams

    inp = np.load(tmp / "i2i.npz")
    images = list(inp["images"])
    params = DiffusionGenerationParams(**gen)
    out = {"img2img": pipe._inner.forward_arrays(prompts, params, init_image=images,
                                                 strength=0.5, output_type="latent"),
           "inpaint": pipe._inner.forward_arrays(prompts, params, init_image=images,
                                                 strength=0.75, mask_image=inp["mask"],
                                                 output_type="latent")}
    np.savez(tmp / f"{stem}_{rank}.npz", **out)


def mesh_rank(rank: int, tmp: str) -> None:
    """:func:`flux_rank`, :func:`pipeline_rank`, :func:`tp_rank`,
    :func:`train_rank`, then :func:`serve_rank`, in one world."""
    flux_rank(rank, tmp)
    pipeline_rank(rank, tmp)
    tp_rank(rank, tmp)
    train_rank(rank, tmp)
    serve_rank(rank, tmp)


def _whole_grads(tree, path=""):
    """(path, whole gradient) of every leaf of a rank's gradient tree: a
    leaf cut over tp is gathered from the group in segment order (a row
    weight's K rows, a column weight's and bias's N columns)."""
    from diffusion_rs_tpu_torch.ops.linear import Linear

    if isinstance(tree, Linear):
        tp, w, b = tree.tp, tree.w, tree.b
        if tp is not None and tp.size > 1 and tp.sharded:
            if tp.role == "col":
                w, b = tp._gather(w), None if b is None else tp._gather(b)
            else:
                w = tp._gather(w.transpose(-1, -2)).transpose(-1, -2)
        yield f"{path}.w", w.numpy()
        if b is not None:
            yield f"{path}.b", b.numpy()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _whole_grads(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree.numpy()


def train_rank(rank: int, tmp: str) -> None:
    """The dryrun's training step (diffusion_rs_tpu_torch.dryrun.train_step)
    on ``tmp/train.pkl``'s params (JAX's, bridged) and
    ``tmp/train_inputs.npz``'s whole batch, at dp=2 x tp=2 (JAX's rule for
    4 devices) and at sp=2 x tp=2: saves the loss and every leaf's whole
    gradient to ``tmp/train_<rank>.npz``."""
    from diffusion_rs_tpu_torch import dryrun
    from diffusion_rs_tpu_torch.parallel import shard_params

    torch.set_num_threads(2)
    tmp = Path(tmp)
    with open(tmp / "train.pkl", "rb") as f:
        blob = pickle.load(f)
    cfg = dryrun.tiny_cfg(blob["heads"])
    params = from_numpy_tree(blob["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in np.load(tmp / "train_inputs.npz").items()}
    out = {}
    for name, axes in (("dp2_tp2", dict(dp=2, tp=2)), ("sp2_tp2", dict(sp=2, tp=2))):
        mesh = make_mesh(**axes, device="cpu")
        loss, grads, _ = dryrun.train_step(shard_params(params, mesh), batch, mesh, cfg)
        out[f"{name}_loss"] = np.array(float(loss))
        out.update({f"{name}:{k}": g for k, g in _whole_grads(grads)})
    np.savez(tmp / f"train_{rank}.npz", **out)


def _watchdog(seconds: float, what: str):
    """A timer that ends this rank's process if ``what`` has not finished
    within ``seconds``: parallel.spawn then fails instead of waiting on a
    hung rank. Cancel it when done."""
    import os
    import sys
    import threading

    def expire():
        print(f"{what} did not finish within {seconds} s", file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    return timer


SERVE_PROMPTS = ["a cat", "a dog", "a fox"]


def serve_rank(rank: int, tmp: str) -> None:
    """``FluxServer`` on ``Pipeline(mesh=...)`` from ``tmp/ckpt`` at dp=2 x
    tp=2 and at dp=2 x sp=2 (max_batch 4, one intra-op thread, noise from
    ``tmp/serve_noise.npz``: the JAX package's draws per seed). Rank 0
    submits SERVE_PROMPTS (2 steps, seeds 1-3), then a prompt longer than
    its T5 length (fails on every rank), a request whose noise fails on the
    other ranks only (seed 99), then "a cat" alone; the others try one
    submit. Saves the images, the failures, ``stats()`` and the followers'
    refusal to ``tmp/serve_<rank>.npz``; a watchdog ends a rank that hangs."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch import serving
    from diffusion_rs_tpu_torch.pipelines.api import ModelSource, Pipeline

    torch.set_num_threads(1)
    tmp = Path(tmp)
    noise = dict(np.load(tmp / "serve_noise.npz"))

    def get_noise(seed, n, h, w, device):
        if seed == 99 and rank != 0:
            raise RuntimeError("injected noise failure")
        return torch.from_numpy(noise[str(seed)]).clone()

    serving.get_noise = get_noise
    timer = _watchdog(120.0, f"serve_rank {rank}")
    out = {}
    for name, axes in (("dp2_tp2", dict(dp=2, tp=2)), ("dp2_sp2", dict(dp=2, sp=2))):
        mesh = make_mesh(**axes, device="cpu")
        pipe = Pipeline(ModelSource.from_model_id(str(tmp / "ckpt")), silent=True, mesh=mesh,
                        device="cpu")
        server = serving.FluxServer(pipe._inner, max_batch=4, poll_ms=300.0)

        def params(seed, **kw):
            return DiffusionGenerationParams(height=64, width=64, num_steps=2,
                                             guidance_scale=3.5, seed=seed, **kw)

        try:
            if rank == 0:
                futs = [server.submit(p, params(i + 1)) for i, p in enumerate(SERVE_PROMPTS)]
                out[f"{name}_images"] = np.stack([f.result(timeout=60) for f in futs])
                errors = []
                for fut in (server.submit("a cat " * 40, params(5, max_sequence_length=8)),
                            server.submit("a cow", params(99))):
                    try:
                        fut.result(timeout=60)
                        errors.append("")
                    except Exception as e:  # the lane's failure, as the leader saw it
                        errors.append(f"{type(e).__name__}: {e}")
                out[f"{name}_errors"] = np.array(errors)
                out[f"{name}_alone"] = server.submit("a cat", params(1)).result(timeout=60)
                stats = server.stats()
                out[f"{name}_stats"] = np.array([stats[k] for k in (
                    "forwards", "lane_steps", "padded_lane_steps", "completed", "failed")])
            else:
                try:
                    server.submit("a cat", params(1))
                    out[f"{name}_refused"] = np.array("")
                except RuntimeError as e:
                    out[f"{name}_refused"] = np.array(str(e))
        finally:
            server.shutdown()
    timer.cancel()
    np.savez(tmp / f"serve_{rank}.npz", **out)


def cuda_ring_rank(rank: int, tmp: str) -> None:
    """Ranks on the card(s), over gloo (sharing one card) or NCCL (a card
    each): each takes its share of the rows of ``tmp/inputs.npz``'s bf16
    q/k/v on its current device, runs the ring in each mode of ``modes``
    and saves its output with the kernels' launch counts and the index of
    the card it ran on."""
    import torch.distributed as dist

    from diffusion_rs_tpu_torch.ops import _cuda

    tmp = Path(tmp)
    inp = np.load(tmp / "inputs.npz")
    world = dist.get_world_size()
    s = inp["q"].shape[2] // world
    q, k, v = (torch.from_numpy(inp[t][:, :, rank * s:(rank + 1) * s]).cuda().bfloat16()
               for t in "qkv")
    out = {"device": np.array(q.device.index)}
    for name in inp["modes"]:
        s8, s8_pv = RING_MODES[str(name)]
        _cuda.reset_launch_counts()
        o = partitioned.ring_attention(q, k, v, dist.group.WORLD, s8=s8, s8_pv=s8_pv)
        out[str(name)] = o.float().cpu().numpy()
        out[f"{name}_launches"] = np.array(sorted(
            (n, c) for n, c in _cuda.launch_counts().items() if c), dtype=object)
    np.savez(tmp / f"cuda_ring_{rank}.npz", **out)


def _forward(tmp: Path, stem: str, mesh, split: str, fuse=()) -> np.ndarray:
    """The FLUX forward of ``tmp/<stem>.pkl`` on ``tmp/<stem>_inputs.npz``
    under ``mesh`` with the params cut over tp (``fuse``: fused first):
    ``split`` "none" feeds every rank the whole batch, "dp" its dp rows,
    "sp" its sp rows of the image tokens; the whole output, gathered."""
    from diffusion_rs_tpu_torch.models.flux import FluxConfig, compute_pe, flux_forward
    from diffusion_rs_tpu_torch.models.optimize import fuse_flux_qkv
    from diffusion_rs_tpu_torch.parallel import batch_sharding, replicated, shard_params

    with open(tmp / f"{stem}.pkl", "rb") as f:
        blob = pickle.load(f)
    cfg = FluxConfig(**blob["cfg"])
    params = from_numpy_tree(blob["params"], "cpu")
    if fuse:
        params = fuse_flux_qkv(params, fuse)
    inp = {k: torch.from_numpy(v) for k, v in np.load(tmp / f"{stem}_inputs.npz").items()}
    rows = {"none": replicated(mesh), "dp": batch_sharding(mesh),
            "sp": batch_sharding(mesh)}[split]
    img = (sequence_sharding(mesh) if split == "sp" else rows).local(inp["img"])
    txt, t, y, txt_ids, img_ids = (rows.local(inp[k]) for k in
                                   ("txt", "t", "y", "txt_ids", "img_ids"))
    local = shard_params(params, mesh)
    o = flux_forward(local, cfg, img, txt, t, y, None, pe=compute_pe(cfg, txt_ids, img_ids),
                     mesh=mesh)
    out_rows = sequence_sharding(mesh) if split == "sp" else rows
    return out_rows.gather(o, (inp["img"].shape[0], inp["img"].shape[1], o.shape[2])).numpy()


def _row_cuts(stem: str, tmp: Path, mesh) -> np.ndarray:
    """Whether each row-parallel linear of the quantized tree is K-cut on
    this rank: (name, sharded, local K) for proj, mlp out and linear2."""
    from diffusion_rs_tpu_torch.parallel import shard_params

    with open(tmp / f"{stem}.pkl", "rb") as f:
        local = shard_params(from_numpy_tree(pickle.load(f)["params"], "cpu"), mesh)
    lins = {"proj": local["double"]["img_attn"]["proj"],
            "mlp_out": local["double"]["img_mlp"]["out"], "linear2": local["single"]["linear2"]}
    return np.array([(n, int(l.tp.sharded), l.w.shape[-2]) for n, l in lins.items()],
                    dtype=object)


def tp_rank(rank: int, tmp: str) -> None:
    """Tensor parallelism in the world of 4: the tiny FLUX forward of
    :func:`flux_rank` at tp=2 (dp=2 x tp=2 with the whole batch on every
    rank; with the fused qkv / qkv_mlp layout), at dp=2 x tp=2 and at
    sp=2 x tp=2; the q8t and q8_0 forwards (``tmp/flux_q8t.pkl``,
    ``flux_q8_0.pkl``) at dp=2 x tp=2 with their row-parallel cuts; T5
    (``tmp/t5.pkl``, nf4) at tp=2, unfused and fused; the multi-host
    helpers. Saves ``tmp/tp_<rank>.npz``."""
    import torch.distributed as dist

    from diffusion_rs_tpu_torch.models.optimize import fuse_t5
    from diffusion_rs_tpu_torch.models.t5 import T5Config, t5_encode
    from diffusion_rs_tpu_torch.parallel import (local_batch_to_global, make_multislice_mesh,
                                                 shard_params)
    from diffusion_rs_tpu_torch.parallel.mesh import all_reduce_sum

    torch.set_num_threads(2)
    tmp = Path(tmp)
    dp_tp = make_mesh(dp=2, tp=2, device="cpu")
    sp_tp = make_mesh(sp=2, tp=2, device="cpu")
    out = {"tp2": _forward(tmp, "flux", dp_tp, "none"),
           "tp2_fused": _forward(tmp, "flux", dp_tp, "none", ("img", "txt", "single")),
           "dp2_tp2": _forward(tmp, "flux", dp_tp, "dp"),
           "sp2_tp2": _forward(tmp, "flux", sp_tp, "sp"),
           "coords": np.array([dp_tp.coords[a] for a in ("dp", "sp", "tp")])}
    for stem in ("flux_q8t", "flux_q8_0"):
        out[stem] = _forward(tmp, stem, dp_tp, "dp")
        out[f"{stem}_cuts"] = _row_cuts(stem, tmp, dp_tp)
    with open(tmp / "t5.pkl", "rb") as f:
        blob = pickle.load(f)
    cfg, ids = T5Config(**blob["cfg"]), torch.from_numpy(blob["ids"])
    t5 = from_numpy_tree(blob["params"], "cpu")
    out["t5"] = t5_encode(shard_params(t5, dp_tp), cfg, ids).numpy()
    out["t5_fused"] = t5_encode(shard_params(fuse_t5(t5), dp_tp), cfg, ids).numpy()
    multi = make_multislice_mesh(sp=1, tp=2, device="cpu")
    local = local_batch_to_global(np.full((2, 4), multi.coords["dp"], np.float32), multi)
    total = all_reduce_sum(local.sum().reshape(1), multi.groups["dp"])
    out["multislice_shape"] = np.array([multi.shape[a] for a in ("dp", "sp", "tp")])
    out["global_sum"] = total.numpy()
    out["world"] = np.array(dist.get_world_size())
    np.savez(tmp / f"tp_{rank}.npz", **out)
