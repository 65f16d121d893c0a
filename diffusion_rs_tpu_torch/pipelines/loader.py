"""Pipeline loading (port of ``diffusion_rs_tpu/pipelines/loader.py``):
model_index.json dispatch -> component assembly.

A :class:`~.source.FileLoader` over the source (directory, hub snapshot or
DDUF), the ``_class_name`` check ("FluxPipeline"), the scheduler, both
tokenizers, CLIP, T5 and the VAE from their component directories, and the
transformer: from ``transformer/`` of the source, from another repo, or
from a single-file GGUF (:func:`load_flux_transformer`, the city96-style
files with BFL tensor names, whose config comes from the tensors).

The load-time weight options (``isq``, ``isq_t5``, ``imatrix``, ``lora``,
``lora_scale``) run in :func:`apply_weight_options`, then the layout
options (``fuse=`` / ``DIFFUSION_RS_TPU_FUSE``, with ``grouped``, and
``DIFFUSION_RS_TPU_FUSED_ROPE=1``) in :func:`apply_layout_options`, with the
JAX package's names, defaults and order. ``mesh=`` (parallel.make_mesh,
built on every rank) turns ``grouped`` off, as in JAX; with tp > 1 FLUX
and T5 are built in host memory and the FluxPipeline cuts them after the
layout options (parallel/sharding.shard_flux_t5: each rank's slices go to
its card; CLIP and the VAE stay whole), so that a rank's card never holds
more of them than its cut; a tp that does not divide the heads or a width
raises ``ValueError``. ``offloading`` keeps weights in host memory:
``Offloading.Full`` builds every component on the CPU and hands the
pipeline a parallel.HostOffload (pinned host copies, each component on the
device around its use); ``Offloading.Stream`` builds the transformer on the
CPU and packs its blocks into a models/flux_streaming.StreamedFlux, the
encoders and the VAE built on the device (a mesh with it raises
``ValueError``). ``compile_cache`` (or DIFFUSION_RS_TPU_COMPILE_CACHE)
points the CUDA kernels' build directory at a persistent one before
anything launches (util/compile_cache.py); ``ModelDType.Auto`` resolves on
the target device (util/dtype.py).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch

from ..io.builders import (
    build_clip_params,
    build_flux_params,
    build_t5_params,
    build_vae_params,
    flux_config_from_bfl,
    is_bfl_naming,
)
from ..io.gguf import GgufFile
from ..io.source import FileLoader
from ..io.tokenizer import load_clip_bpe_tokenizer, load_t5_tokenizer_from_bytes
from ..io.varstore import VarStore
from ..models.clip import ClipTextConfig
from ..models.flux import FluxConfig
from ..models.flux_streaming import StreamedFlux
from ..models.t5 import T5Config
from ..models.vae import VAEConfig
from ..parallel.offload import HostOffload
from ..util.device import resolve_device
from ..util.dtype import resolve_auto_dtype
from ..util.tree import tree_leaves
from .api import ModelDType, ModelSource, Offloading
from .flux_pipeline import FluxPipeline
from .scheduler import SchedulerConfig

log = logging.getLogger("diffusion_rs_tpu_torch")

# The JAX package's per-stream fusion default: empty, by its measurement on
# a TPU (every fusion and grouping variant lost end to end there). The
# port keeps the default so that both packages load the same layout.
_FUSE_MEASURED_DEFAULT: tuple = ()
_FUSE_ALL = ("img", "txt", "single", "t5")

_DTYPES = {ModelDType.BF16: torch.bfloat16, ModelDType.F16: torch.float16,
           ModelDType.F32: torch.float32}


def _resolve_fuse(fuse) -> tuple:
    """The fuse selection: None -> DIFFUSION_RS_TPU_FUSE -> the measured
    default; True / "1" / "all" -> every stream; a string -> its comma list
    (tokens "img", "txt", "single", "t5", "grouped")."""
    if fuse is None:
        env = os.environ.get("DIFFUSION_RS_TPU_FUSE", "")
        if env == "":
            return _FUSE_MEASURED_DEFAULT
        fuse = env
    if fuse in (False, "0", ""):
        return ()
    if fuse in (True, "1", "all"):
        return _FUSE_ALL
    if isinstance(fuse, str):
        return tuple(s.strip() for s in fuse.split(",") if s.strip())
    return tuple(fuse)


def apply_layout_options(flux_params: dict, flux_cfg: FluxConfig, t5_params: dict,
                         fuse=None, silent: bool = True, mesh=None
                         ) -> Tuple[dict, FluxConfig, dict]:
    """The JAX loader's load-time layout transforms, in its order: projection
    fusion (``fuse``; ``grouped`` adds the img and txt streams and sets
    ``grouped_qmm``, or under a ``mesh`` is dropped with JAX's warning),
    then, with DIFFUSION_RS_TPU_FUSED_ROPE=1, the RoPE half-split re-layout
    of the final q/k columns (sets ``rope_fused``). A transform that does
    not apply (mixed dense/quantized weights, LoRA terms) is skipped with a
    log line, as in JAX. Returns the new FLUX params and config and the T5
    params."""
    from ..models.optimize import fuse_flux_qkv, fuse_t5, rope_halfsplit_permute
    from ..util.tracing import warn_once

    streams = _resolve_fuse(fuse)
    if "grouped" in streams:
        if mesh is not None:
            warn_once("grouped-mesh", "fuse='grouped' has no mesh partitioning rule; "
                                      "running the per-stream calls instead")
            streams = tuple(s for s in streams if s != "grouped")
        else:
            streams = tuple(dict.fromkeys(streams + ("img", "txt")))
    if streams:
        try:
            flux_params = fuse_flux_qkv(flux_params, streams)
        except ValueError as e:
            if not silent:
                log.info("qkv fusion skipped: %s", e)
        if "t5" in streams:
            try:
                t5_params = fuse_t5(t5_params)
            except ValueError as e:
                if not silent:
                    log.info("t5 fusion skipped: %s", e)
        if "grouped" in streams:
            flux_cfg = dataclasses.replace(flux_cfg, grouped_qmm=True)
    if os.environ.get("DIFFUSION_RS_TPU_FUSED_ROPE", "0") == "1":
        try:
            flux_params = rope_halfsplit_permute(flux_params, flux_cfg)
            flux_cfg = dataclasses.replace(flux_cfg, rope_fused=True)
        except (ValueError, KeyError, TypeError) as e:
            if not silent:
                log.info("rope half-split re-layout skipped: %s", e)
    return flux_params, flux_cfg, t5_params


def apply_weight_options(flux_params: dict, flux_cfg: FluxConfig, t5_params: dict,
                         isq: Optional[str] = None, isq_t5: Optional[str] = None,
                         imatrix: Optional[str] = None,
                         lora: Union[str, Sequence[str], None] = None,
                         lora_scale: Union[float, Sequence[float]] = 1.0,
                         dtype=torch.bfloat16, silent: bool = True,
                         offloading: Optional[Offloading] = None,
                         tp: int = 1, device=None) -> Tuple[dict, dict]:
    """The JAX loader's load-time weight transforms, in its order, on
    in-memory trees and on their own device: ISQ of FLUX (``isq``, weighted
    by the ``imatrix`` file when given), the T5 capacity guard, ISQ of T5,
    then each LoRA file with its scale. Returns the FLUX and T5 params.

    T5 follows ``isq`` unless ``isq_t5`` names its own target; the guard
    keeps T5 in its present format when following ``isq`` would put FLUX
    and T5 together over 92% of the device budget (util/capacity.py) and
    its present format is the smaller, both trees' bytes divided by ``tp``
    (the mesh's tensor-parallel degree; the trees are still whole here), as
    in JAX; it runs for a CUDA ``device`` (the one the weights are for;
    None: the trees' own), or where
    DIFFUSION_RS_TPU_HBM_BYTES sets a budget, and not under ``offloading``
    (the encoders are not device-resident there), as in JAX. ``imatrix``
    and ``isq_t5`` do nothing without ``isq``. LoRA factors fuse into dense
    bases and become runtime terms on quantized ones (io/lora.py), so an
    ISQ'd base keeps its adapter outside the quantizer."""
    from ..io.imatrix import load_imatrix
    from ..io.lora import apply_flux_lora
    from ..quant.isq import isq_tree
    from ..util import capacity
    from ..util.tracing import warn_once

    if isq:
        imat = load_imatrix(imatrix) if imatrix else None
        flux_params = isq_tree(flux_params, isq, imatrix=imat)
        t5_target = isq_t5 if isq_t5 is not None else isq
        device = tree_leaves(flux_params)[0].device if device is None else torch.device(device)
        if isq_t5 is None and offloading is None and (
                device.type == "cuda" or os.environ.get("DIFFUSION_RS_TPU_HBM_BYTES")):
            budget = int(0.92 * capacity.per_chip_hbm_bytes(device))  # 8% headroom
            flux_b = capacity.tree_device_bytes(flux_params) // tp
            t5_now = capacity.tree_device_bytes(t5_params) // tp
            t5_isq = capacity.estimate_isq_tree_bytes(t5_params, isq) // tp
            if flux_b + t5_isq > budget and t5_now < t5_isq:
                warn_once(
                    "isq-t5-capacity",
                    f"isq='{isq}' would put T5 at ~{t5_isq / 1e9:.1f} GB beside "
                    f"{flux_b / 1e9:.1f} GB transformer weights — over the "
                    f"{budget / 1e9:.1f} GB budget; keeping T5 in its current "
                    "(smaller) format. Pass isq_t5= to force, or shard with a tp mesh.")
                t5_target = None
        if t5_target:
            t5_params = isq_tree(t5_params, t5_target, imatrix=imat)
        if not silent:
            log.info("applied ISQ (%s%s) to transformer%s linears", isq,
                     ", imatrix-weighted" if imat else "",
                     f" + T5 ({t5_target})" if t5_target else " (T5 kept)")
    if lora:
        loras = [lora] if isinstance(lora, str) else list(lora)
        scales = ([lora_scale] * len(loras) if isinstance(lora_scale, (int, float))
                  else list(lora_scale))
        if len(scales) != len(loras):
            raise ValueError(f"{len(loras)} LoRA files but {len(scales)} scales")
        for lf, sc in zip(loras, scales):
            flux_params = apply_flux_lora(flux_params, flux_cfg, lf, scale=sc, dtype=dtype)
            if not silent:
                log.info("applied LoRA %s (scale %.2f)", lf, sc)
    return flux_params, t5_params


def _component_store(loader: FileLoader, prefix: str, dtype, device,
                     silent: bool = True) -> VarStore:
    """A component's weights: its safetensors and/or GGUF files."""
    from ..util.progress import progress

    store = VarStore(default_dtype=dtype, device=device)
    files = [n for n in loader.list_files()
             if n.startswith(prefix + "/") and n.endswith((".safetensors", ".gguf"))]
    if not files:
        raise FileNotFoundError(f"no safetensors/gguf under {prefix}/")
    for name in progress(files, desc=f"load {prefix}", silent=silent):
        if name.endswith(".safetensors"):
            store.add_safetensors(loader.safetensors(name))
        else:
            if loader.root is None:
                raise ValueError("GGUF components require a directory source")
            store.add_gguf(GgufFile(str(loader.root / name)))
    return store


def load_flux_transformer(path: Union[str, Path], base_cfg: Optional[FluxConfig] = None,
                          dtype=torch.bfloat16, device="cuda"
                          ) -> Tuple[dict, FluxConfig]:
    """FLUX params and config from a single-file GGUF transformer.

    BFL tensor names (city96-style files): the config comes from the tensor
    keys and shapes, on top of ``base_cfg`` (axes_dim, ...; the defaults
    when None). Quantized linears stay quantized (canonical planes on
    ``device``); dense tensors are cast to ``dtype``. A diffusers-named GGUF
    takes its config from ``base_cfg``, which it then requires."""
    device = resolve_device(device)
    store = VarStore(default_dtype=dtype, device=device)
    store.add_gguf(GgufFile(str(path)))
    if is_bfl_naming(store):
        cfg = flux_config_from_bfl(store, base=base_cfg)
    elif base_cfg is not None:
        cfg = base_cfg
    else:
        raise ValueError(f"{path}: diffusers-named GGUF transformer needs base_cfg "
                         "(the base repo's transformer/config.json)")
    return build_flux_params(store, cfg, dtype), cfg


def load_pipeline(
    source: ModelSource,
    silent: bool = False,
    token: Optional[str] = None,
    revision: Optional[str] = None,
    offloading: Optional[Offloading] = None,
    dtype: ModelDType = ModelDType.Auto,
    isq: Optional[str] = None,
    isq_t5: Optional[str] = None,
    fuse=None,
    imatrix: Optional[str] = None,
    lora: Union[str, Sequence[str], None] = None,
    lora_scale: Union[float, Sequence[float]] = 1.0,
    mesh=None,
    t5_mask_pads: Optional[bool] = None,
    step_progress: Optional[bool] = None,
    compile_cache: Optional[str] = None,
    device="cuda",
) -> FluxPipeline:
    from ..util.compile_cache import enable_compile_cache

    # before any kernel launch: the first one builds into, or loads from,
    # the cache directory
    enable_compile_cache(compile_cache)
    if mesh is not None and offloading is Offloading.Stream:
        raise ValueError("mesh and Offloading.Stream are mutually exclusive")
    device = resolve_device(device)
    if mesh is not None and device.type == "cuda":
        device = mesh.device
    tp = 1 if mesh is None else mesh.shape["tp"]
    # offloading keeps the weights in host memory: build them there (under
    # Stream only the transformer's; the encoders and the VAE stay resident).
    # Under tp FLUX and T5 are built there too: the pipeline moves each
    # rank's cut of them to its card.
    cpu = torch.device("cpu")
    flux_build = cpu if offloading is not None or tp > 1 else device
    build = cpu if offloading is Offloading.Full else device
    t5_build = cpu if tp > 1 else build
    loader = FileLoader(model_id=source.model_id, dduf_file=source.dduf_file,
                        token=token, revision=revision, silent=silent)
    index = json.loads(loader.read_bytes("model_index.json"))
    class_name = index.get("_class_name")
    if class_name != "FluxPipeline":
        raise ValueError(f"unsupported pipeline class {class_name!r}")
    dt = resolve_auto_dtype(device) if dtype is ModelDType.Auto else _DTYPES[dtype]
    if not silent:
        log.info("loading FluxPipeline (dtype=%s, device=%s)", dt, device)

    def config(name: str) -> dict:
        return json.loads(loader.read_bytes(name))

    scheduler = SchedulerConfig.from_json(config("scheduler/scheduler_config.json"))
    clip_tokenizer = load_clip_bpe_tokenizer(loader.read_bytes("tokenizer/vocab.json"),
                                             loader.read_bytes("tokenizer/merges.txt"))
    t5_tokenizer = load_t5_tokenizer_from_bytes(
        loader.read_bytes("tokenizer_2/tokenizer.json"))

    clip_cfg = ClipTextConfig.from_json(config("text_encoder/config.json"))
    clip_params = build_clip_params(_component_store(loader, "text_encoder", dt, build, silent),
                                    clip_cfg, dt)
    t5_cfg = T5Config.from_json(config("text_encoder_2/config.json"))
    t5_params = build_t5_params(
        _component_store(loader, "text_encoder_2", dt, t5_build, silent), t5_cfg, dt)
    vae_cfg = VAEConfig.from_json(config("vae/config.json"))
    vae_params = build_vae_params(_component_store(loader, "vae", dt, build, silent), vae_cfg, dt)
    if not silent:
        log.info("loaded CLIP (%d layers), T5 (%d layers), VAE %s",
                 clip_cfg.num_hidden_layers, t5_cfg.num_layers,
                 list(vae_cfg.block_out_channels))

    override = source.transformer_model_id
    if override and override.endswith(".gguf") and os.path.isfile(override):
        base_cfg = (FluxConfig.from_json(config("transformer/config.json"))
                    if loader.exists("transformer/config.json") else None)
        flux_params, flux_cfg = load_flux_transformer(override, base_cfg, dt, flux_build)
        if not silent:
            log.info("transformer from single-file GGUF %s", override)
    else:
        flux_loader = loader
        if override:
            flux_loader = FileLoader(model_id=override, token=token, revision=revision,
                                     silent=silent)
        flux_cfg = FluxConfig.from_json(
            json.loads(flux_loader.read_bytes("transformer/config.json")))
        flux_params = build_flux_params(
            _component_store(flux_loader, "transformer", dt, flux_build, silent), flux_cfg, dt)
    flux_params, t5_params = apply_weight_options(
        flux_params, flux_cfg, t5_params, isq=isq, isq_t5=isq_t5, imatrix=imatrix, lora=lora,
        lora_scale=lora_scale, dtype=dt, silent=silent, offloading=offloading, tp=tp,
        device=device)
    flux_params, flux_cfg, t5_params = apply_layout_options(
        flux_params, flux_cfg, t5_params, fuse=fuse, silent=silent, mesh=mesh)
    if not silent:
        log.info("loaded FLUX transformer (%d double + %d single blocks, guidance=%s)",
                 flux_cfg.num_layers, flux_cfg.num_single_layers, flux_cfg.guidance_embeds)

    offload = streamed = None
    if offloading is Offloading.Full:
        offload = HostOffload()
    elif offloading is Offloading.Stream:
        streamed = StreamedFlux(flux_params, flux_cfg, device=device)
        flux_params = None  # the packed host buffers inside StreamedFlux
        if not silent:
            log.info("transformer weights in host memory (per-block streaming)")
    # under tp the pipeline cuts FLUX and T5 (after ISQ, LoRA, fuse= and the
    # RoPE re-layout, as in JAX)
    return FluxPipeline(
        flux_params=flux_params, flux_cfg=flux_cfg, t5_params=t5_params, t5_cfg=t5_cfg,
        clip_params=clip_params, clip_cfg=clip_cfg, vae_params=vae_params,
        vae_cfg=vae_cfg, scheduler=scheduler, t5_tokenizer=t5_tokenizer,
        clip_tokenizer=clip_tokenizer, dtype=dt, device=device, mesh=mesh,
        t5_mask_pads=t5_mask_pads, step_progress=step_progress, offload=offload,
        streamed=streamed,
    )
