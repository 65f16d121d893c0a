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
    with JAX's warning)."""
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
    np.savez(tmp / f"pipe_{rank}.npz", images=images, latents=latents, rings=np.array(rings),
             full_images=full_images,
             full_released=np.array(not full._inner.offload._refs
                                    and full._inner.offload.manages("flux")),
             digest=_digest(pipe._inner.flux_params),
             fallback=np.array(any(WARN_TEXT in m for m in warned.messages)),
             grouped_qmm=np.array(grouped.flux_cfg.grouped_qmm),
             grouped_fused="qkv" in grouped.flux_params["double"]["img_attn"],
             grouped_warned=np.array(any("fuse='grouped' has no mesh partitioning rule" in m
                                         for m in warned.messages)))


def img2img_rank(rank: int, tmp: Path, pipe, gen: dict, prompts) -> None:
    """img2img (strength 0.5) and inpaint (0.75) through ``pipe`` (under the
    mesh) on ``tmp/i2i.npz``'s init images and latent-size mask, with the
    port's own encoder sample for the seed: saves the packed latents of both
    to ``tmp/i2i_<rank>.npz``."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams

    inp = np.load(tmp / "i2i.npz")
    images = list(inp["images"])
    params = DiffusionGenerationParams(**gen)
    out = {"img2img": pipe._inner.forward_arrays(prompts, params, init_image=images,
                                                 strength=0.5, output_type="latent"),
           "inpaint": pipe._inner.forward_arrays(prompts, params, init_image=images,
                                                 strength=0.75, mask_image=inp["mask"],
                                                 output_type="latent")}
    np.savez(tmp / f"i2i_{rank}.npz", **out)


def mesh_rank(rank: int, tmp: str) -> None:
    """:func:`flux_rank`, then :func:`pipeline_rank`, in one world."""
    flux_rank(rank, tmp)
    pipeline_rank(rank, tmp)


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
