"""Benchmark harness of the port: the counterpart of the repo's root
``bench.py`` (which measures the JAX package), with the same modes,
presets and flags, on synthetic full-size weights made from a seed.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": null, "device": ...}

``vs_baseline`` is null: the root bench's baselines are TPU numbers, which
say nothing about a GPU. ``device`` names the card (or ``cpu``).

Modes:
  * ``image`` (default): whole-image latency through
    ``FluxPipeline.forward_arrays`` (T5-XXL + CLIP-L encode, the Euler
    denoise over 19 double + 38 single blocks, the VAE decode), FLUX.1-dev
    1024x1024, 28 steps, batch 1, FLUX q8t and T5 nf4 by default; the step
    is derived from a second, shorter image: (t_full - t_few) / (steps -
    few).
  * ``step``: the transformer step alone (the ``dev-1024-bf16`` preset
    streams bf16 blocks from host memory, models/flux_streaming.py, and
    reports ``overlap_report``).
  * ``serve``: ``FluxServer`` throughput (serving.py) against the same
    requests one by one through the pipeline: ``--serve-workload mixed``
    (every 4th request an img2img lane at strength 0.6; the encode cache
    off, so the row measures batching) or ``lru`` (requests over 2 unique
    prompts, the cache on against off).

``--device cpu`` runs the plain PyTorch versions (``--small`` sizes);
``--mesh`` takes ``dp=,sp=,tp=`` (every rank runs this script after
``parallel.init_multihost``'s environment; image mode); under ``tp`` each
rank keeps its cut of the FLUX and T5 weights (parallel/sharding.py).

Usage: python -m diffusion_rs_tpu_torch.bench [--mode image|step|serve]
       [--small] [--preset NAME] [--impl q4|q8t|dense] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import statistics
import sys
import time

import numpy as np
import torch

# The root bench's configurations (BASELINE.md targets 1-5): 1 schnell q4
# 256^2 x4 steps; 2 dev q8t 720x1280 x50; 3 dev bf16 1024^2 x28 (streamed);
# 4 schnell q4 batch 8 1024^2 with the encoders offloaded; 5 dev q4 2048^2.
PRESETS = {
    "schnell-256": dict(res=256, batch=1, impl="q8t", guidance=False, txt=256, steps=4),
    "dev-720x1280": dict(res=(720, 1280), batch=1, impl="q8t", guidance=True, txt=512, steps=50),
    "dev-1024-bf16": dict(res=1024, batch=1, impl="dense", guidance=True, txt=512, steps=28),
    "schnell-1024-b8": dict(res=1024, batch=8, impl="q4", guidance=False,
                            txt=256, steps=4, offload_encoders=True),
    "dev-2048": dict(res=2048, batch=1, impl="q4", guidance=True, txt=512,
                     steps=28, offload_encoders=True),
}


def _configs(small: bool, guidance: bool) -> dict:
    """The four components' configs: FLUX.1 / T5-XXL / CLIP-L / the VAE, or
    the CPU-sized ``--small`` set."""
    from .models.clip import ClipTextConfig
    from .models.flux import FluxConfig
    from .models.t5 import T5Config
    from .models.vae import VAEConfig

    if not small:
        return dict(flux_cfg=FluxConfig(guidance_embeds=guidance), t5_cfg=T5Config(),
                    clip_cfg=ClipTextConfig(), vae_cfg=VAEConfig())
    return dict(
        flux_cfg=FluxConfig(in_channels=64, pooled_projection_dim=64, joint_attention_dim=64,
                            num_attention_heads=4, num_layers=2, num_single_layers=4,
                            guidance_embeds=guidance, hidden_size=128, axes_dim=(8, 12, 12)),
        t5_cfg=T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                        num_heads=4),
        clip_cfg=ClipTextConfig(vocab_size=512, projection_dim=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4),
        # four blocks: the encoder's stride 8 matches the latent size (img2img lanes)
        vae_cfg=VAEConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8),
    )


def _flux_params(cfg, impl: str, small: bool, device):
    """FLUX weights in the ``--impl`` format: q8t, q4 (nf4: the root bench's
    q4 exec format) or dense bf16; dense at ``--small``."""
    from .util import synthetic as syn

    if small or impl == "dense":
        return syn.init_flux_params(0, cfg, device=device)
    return syn.init_flux_params_quantized(0, cfg, kind="q8t" if impl == "q8t" else "nf4",
                                          device=device)


def _maybe_rope_fused(params, cfg):
    """The loader's opt-in RoPE half-split re-layout under
    DIFFUSION_RS_TPU_FUSED_ROPE=1 and no projection fusion, as the root
    bench applies it (the bench builds params directly)."""
    from .pipelines.loader import apply_layout_options

    params, cfg, _ = apply_layout_options(params, cfg, {}, fuse="0")
    return params, cfg


def _t5_params(cfg, impl: str, t5_impl: str, small: bool, device):
    from .util import synthetic as syn

    if small or impl == "dense":
        return syn.init_t5_params(1, cfg, device=device)
    return syn.init_t5_params_quantized(1, cfg, kind="q8t" if t5_impl == "q8t" else "nf4",
                                        device=device)


def _pipeline(cfgs, flux_params, t5_params, device, dynamic_shift: bool, offload=None,
              mesh=None):
    """The FluxPipeline on seeded synthetic CLIP-L and VAE weights (CLIP in
    host memory under ``offload``); under a ``mesh`` with tp > 1 the
    pipeline cuts FLUX and T5 to this rank's slices."""
    from .pipelines.flux_pipeline import FluxPipeline
    from .pipelines.scheduler import SchedulerConfig
    from .util import synthetic as syn

    enc_dev = "cpu" if offload is not None else device
    vae = {**syn.init_vae_decoder_params(3, cfgs["vae_cfg"], device=device),
           **syn.init_vae_encoder_params(4, cfgs["vae_cfg"], device=device)}
    return FluxPipeline(
        flux_params=flux_params, t5_params=t5_params,
        clip_params=syn.init_clip_params(2, cfgs["clip_cfg"], device=enc_dev),
        vae_params=vae, scheduler=SchedulerConfig(use_dynamic_shifting=dynamic_shift),
        t5_tokenizer=syn.WordTokenizer(cfgs["t5_cfg"].vocab_size),
        clip_tokenizer=syn.WordTokenizer(cfgs["clip_cfg"].vocab_size),
        dtype=torch.bfloat16, device=device, mesh=mesh, offload=offload, **cfgs)


def _parse_mesh(spec, device):
    """'dp=2,sp=2' or 'tp=2' -> parallel.make_mesh over the ranks of
    ``parallel.init_multihost`` (an axis left out: 1, tp what dp and sp
    leave)."""
    if not spec:
        return None
    from .parallel import init_multihost, make_mesh

    axes = {k.strip(): int(v) for k, v in (part.split("=") for part in spec.split(","))}
    init_multihost()
    return make_mesh(dp=axes.get("dp", 1), sp=axes.get("sp", 1), tp=axes.get("tp"),
                     device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _print(metric: str, value: float, device) -> None:
    print(json.dumps({"metric": metric, "value": value, "unit": "images/sec/chip",
                      "vs_baseline": None, "device": _device_name(device)}))


def bench_image(args, preset) -> int:
    """Whole-image latency (encode + denoise + decode) through FluxPipeline."""
    from .parallel.offload import HostOffload
    from .pipelines.flux_pipeline import DiffusionGenerationParams
    from .util.device import resolve_device

    mesh = _parse_mesh(args.mesh, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    guidance = preset["guidance"] if preset else True
    cfgs = _configs(args.small, guidance)
    if args.small:
        res, steps = (128, 128), args.steps_image or 4
    else:
        res = preset["res"] if preset else args.res
        steps = args.steps_image or (preset["steps"] if preset else 28)
    if isinstance(res, int):
        res = (res, res)
    offload_enc = bool(not args.small and preset and preset.get("offload_encoders"))
    # the big-batch configs keep the encoders in host memory, copied to the
    # device around the encode
    offload = HostOffload(only=("t5", "clip")) if offload_enc else None
    flux_params, flux_cfg = _maybe_rope_fused(
        _flux_params(cfgs["flux_cfg"], args.impl, args.small, device), cfgs["flux_cfg"])
    t5_params = _t5_params(cfgs["t5_cfg"], args.impl, args.t5_impl, args.small,
                           "cpu" if offload_enc else device)
    pipe = _pipeline({**cfgs, "flux_cfg": flux_cfg}, flux_params, t5_params, device,
                     dynamic_shift=flux_cfg.guidance_embeds, offload=offload, mesh=mesh)
    del flux_params, t5_params  # under tp the pipeline holds only this rank's cut
    b = preset["batch"] if preset else args.batch
    impl = "dense-small" if args.small else args.impl
    if args.t5_impl == "q8t":
        impl += "+t5q8t"
    prompts = [f"a photo of test subject {i}" for i in range(b)]

    def timed_image(num_steps: int):
        gp = DiffusionGenerationParams(height=res[0], width=res[1], num_steps=num_steps,
                                       guidance_scale=3.5, seed=7)
        try:
            pipe.forward_arrays(prompts, gp)  # warm-up
        except torch.cuda.OutOfMemoryError:
            return None
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            pipe.forward_arrays(prompts, gp)  # ends with the images on the host
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    few = max(1, min(4, steps // 2))
    t_full = timed_image(steps)
    if t_full is None:
        _print(f"FLUX.1 {res[0]}x{res[1]} {impl} whole image: exceeds the card's memory "
               "(needs a mesh or offloading)", 0.0, device)
        return 0
    t_few = timed_image(few) if few < steps else None
    if t_few is not None and t_few < t_full:
        step_s = (t_full - t_few) / (steps - few)
        detail = (f"p50 step {step_s * 1e3:.1f} ms, "
                  f"encode+decode {max(0.0, t_few - few * step_s) * 1e3:.0f} ms")
    else:  # a noisy host at --iters 1: the whole-image figure only
        detail = "single-timing"
    variant = "-dev" if flux_cfg.guidance_embeds else "-schnell"
    if mesh is None or not any(mesh.coords.values()):
        _print(f"FLUX.1{variant} {res[0]}x{res[1]} {impl} WHOLE-IMAGE images/sec ({steps} "
               f"steps + T5/CLIP encode + VAE decode, image {t_full:.2f} s, {detail}, "
               f"batch {b})", b / t_full, device)
    return 0


def bench_serve(args, preset) -> int:
    """Serving throughput: the requests through FluxServer's continuous
    batching against the same requests one by one through the pipeline."""
    from .pipelines.flux_pipeline import DiffusionGenerationParams
    from .serving import FluxServer
    from .util.device import resolve_device

    device = resolve_device(args.device)
    cfgs = _configs(args.small, guidance=False)  # schnell-style serving
    if args.small:
        res, steps, n_req = 128, 2, 6
    else:
        res, steps, n_req = args.res, 4, 8
    flux_params, flux_cfg = _maybe_rope_fused(
        _flux_params(cfgs["flux_cfg"], args.impl, args.small, device), cfgs["flux_cfg"])
    t5_params = _t5_params(cfgs["t5_cfg"], "q4", "q4", args.small, device)
    pipe = _pipeline({**cfgs, "flux_cfg": flux_cfg}, flux_params, t5_params, device,
                     dynamic_shift=False)
    gp = DiffusionGenerationParams(height=res, width=res, num_steps=steps, guidance_scale=0.0,
                                   seed=1)
    impl = "dense-small" if args.small else args.impl
    max_batch = args.batch if args.batch > 1 else 4

    if args.serve_workload == "lru":
        # the gallery workload the prompt cache targets: n_req requests over 2
        # prompts; the baseline is the same server with the cache off
        prompts = [f"popular prompt {i % 2}" for i in range(n_req)]

        def run_lru(cache_size: int):
            server = FluxServer(pipe, max_batch=max_batch, encode_cache=cache_size)
            try:
                [f.result() for f in [server.submit(p, gp) for p in prompts]]  # warm
                h0 = server.stats()["encode_cache_hits"]
                t0 = time.perf_counter()
                [f.result() for f in [server.submit(p, gp) for p in prompts]]
                dt = time.perf_counter() - t0
                hits = server.stats()["encode_cache_hits"] - h0
            finally:
                server.shutdown()
            return dt, hits

        t_off, _ = run_lru(0)
        t_on, hits = run_lru(32)
        _print(f"FLUX.1-schnell {res}x{res} {impl} serving with prompt-LRU ({n_req} "
               f"requests over 2 unique prompts, {hits}/{n_req} encode hits; cache-off "
               f"{n_req / t_off:.3f} img/s, {t_off / t_on:.3f}x)", n_req / t_on, device)
        return 0

    prompts = [f"subject number {i}" for i in range(n_req)]
    # every 4th request img2img (strength 0.6: a truncated lane schedule)
    init_img = np.random.default_rng(7).integers(0, 256, (res, res, 3), dtype=np.uint8)
    is_i2i = [i % 4 == 3 for i in range(n_req)]
    i2i = dict(init_image=init_img, strength=0.6)

    def seq_one(p, lane_i2i):
        pipe.forward_arrays([p], gp, **(i2i if lane_i2i else {}))

    seq_one(prompts[0], False)  # warm-up of both offline paths
    if any(is_i2i):
        seq_one(prompts[0], True)
    t0 = time.perf_counter()
    for p, lane_i2i in zip(prompts, is_i2i):
        seq_one(p, lane_i2i)
    seq_s = time.perf_counter() - t0
    # the cache off: the warm pass repeats the timed pass's prompts, and the
    # row measures batching, not encode skips the sequential run pays
    server = FluxServer(pipe, max_batch=max_batch, encode_cache=0)
    try:
        def submit_all():
            return [server.submit(p, gp, **(i2i if lane_i2i else {}))
                    for p, lane_i2i in zip(prompts, is_i2i)]

        [f.result() for f in submit_all()]  # warm-up at the batch buckets
        t0 = time.perf_counter()
        [f.result() for f in submit_all()]
        srv_s = time.perf_counter() - t0
        occ = server.stats()["occupancy"]
    finally:
        server.shutdown()
    _print(f"FLUX.1-schnell {res}x{res} {impl} serving throughput ({n_req} requests, "
           f"{sum(is_i2i)} img2img lanes, {steps} steps, max_batch {max_batch}, occupancy "
           f"{occ:.0%}; sequential {n_req / seq_s:.3f} img/s, {seq_s / srv_s:.3f}x)",
           n_req / srv_s, device)
    return 0


def bench_step(args, preset) -> int:
    """The transformer denoise step alone (synthetic weights)."""
    from .models.flux import compute_pe, flux_forward
    from .models.flux_streaming import StreamedFlux
    from .pipelines.loader import apply_layout_options
    from .pipelines.sampling import make_img_ids, make_txt_ids
    from .util import synthetic as syn
    from .util.device import resolve_device
    from .util.tracing import maybe_profile
    from .util.tree import take_layer

    device = resolve_device(args.device)
    guidance = True if args.small or not preset else preset["guidance"]
    cfg = _configs(args.small, guidance)["flux_cfg"]
    if args.small:
        res, txt_len = (256, 256), 64
    else:
        res = preset["res"] if preset else args.res
        txt_len = preset["txt"] if preset else 512
    if isinstance(res, int):
        res = (res, res)
    dt = torch.bfloat16
    streamed = args.preset == "dev-1024-bf16"
    if streamed:
        args.impl = "bf16-streamed"
        # 24 GB of bf16 blocks in host memory, copied block by block: one
        # random block of each kind, packed once per layer (every copy moves
        # its own bytes)
        one_cfg = dataclasses.replace(cfg, num_layers=1, num_single_layers=1)
        one, one_cfg = _maybe_rope_fused(syn.init_flux_params(0, one_cfg, device="cpu"),
                                         one_cfg)
        cfg = dataclasses.replace(one_cfg, num_layers=cfg.num_layers,
                                  num_single_layers=cfg.num_single_layers)
        pre = {k: one[k] for k in ("img_in", "txt_in", "time_in", "vector_in", "guidance_in")
               if k in one}
        sf = StreamedFlux.from_block_trees(
            pre, one["final"], itertools.repeat(take_layer(one["double"], 0), cfg.num_layers),
            itertools.repeat(take_layer(one["single"], 0), cfg.num_single_layers), cfg,
            device=device)
    else:
        params = _flux_params(cfg, args.impl, args.small, device)
        # DIFFUSION_RS_TPU_FUSE and DIFFUSION_RS_TPU_FUSED_ROPE, as the loader reads them
        params, cfg, _ = apply_layout_options(params, cfg, {}, fuse=None)

    b = preset["batch"] if preset else args.batch
    h2, w2 = (res[0] + 15) // 16, (res[1] + 15) // 16
    gen = torch.Generator(device=device).manual_seed(1)
    img = torch.randn((b, h2 * w2, cfg.in_channels), generator=gen, device=device).to(dt)
    txt = torch.randn((b, txt_len, cfg.joint_attention_dim), generator=gen,
                      device=device).to(dt)
    y = torch.randn((b, cfg.pooled_projection_dim), generator=gen, device=device).to(dt)
    pe = compute_pe(cfg, make_txt_ids(b, txt_len, device), make_img_ids(b, h2, w2, device))
    t = torch.full((b,), 0.7, dtype=torch.float32, device=device)
    g = torch.full((b,), 3.5, dtype=torch.float32, device=device)

    if streamed:
        img = img.float()

        def step(x):
            return sf.step(x, txt, 0.7, 0.7 - 1.0 / 28.0, y, g, pe)
    else:
        def step(x):
            return x + flux_forward(params, cfg, x, txt, t, y, g, pe=pe) * (-1.0 / 28.0)

    with torch.no_grad():
        try:
            img = step(img)  # warm-up
            _sync(device)
        except torch.cuda.OutOfMemoryError:
            _print(f"FLUX.1 {res[0]}x{res[1]} {args.impl}: exceeds the card's memory "
                   "(needs a mesh or offloading)", 0.0, device)
            return 0
        times = []
        # DIFFUSION_RS_TPU_TRACE_DIR captures a profiler trace of the timed steps
        with maybe_profile("denoise-step"):
            for _ in range(args.steps):
                t0 = time.perf_counter()
                img = step(img)
                _sync(device)
                times.append(time.perf_counter() - t0)
        overlap = ""
        if streamed:
            rep = sf.overlap_report(img, txt, y, g, pe, iters=2)
            overlap = "; stream overlap " + json.dumps(rep)
    p50 = statistics.median(times)
    _print(f"FLUX.1{'-dev' if cfg.guidance_embeds else '-schnell'} {res[0]}x{res[1]} "
           f"{'dense-small' if args.small else args.impl} images/sec (transformer step only; "
           f"28 steps, p50 step {p50 * 1e3:.1f} ms, batch {b}{overlap})",
           b / (28.0 * p50), device)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m diffusion_rs_tpu_torch.bench")
    ap.add_argument("--mode", choices=["image", "step", "serve"], default="image",
                    help="image = whole pipeline (encode+denoise+decode); step = transformer "
                         "denoise step only; serve = continuous-batching throughput vs "
                         "sequential")
    ap.add_argument("--small", action="store_true", help="CPU-sized smoke config")
    ap.add_argument("--steps", type=int, default=8, help="timed denoise steps (step mode)")
    ap.add_argument("--steps-image", type=int, default=None,
                    help="denoise steps per image (image mode; default preset)")
    ap.add_argument("--iters", type=int, default=3, help="timed images (image mode)")
    ap.add_argument("--impl", choices=["q4", "q8t", "dense"], default=None,
                    help="FLUX exec format (default: the preset's, else q8t)")
    ap.add_argument("--t5-impl", choices=["q4", "q8t"], default="q4",
                    help="T5 exec format (q4 = nf4)")
    ap.add_argument("--serve-workload", choices=["mixed", "lru"], default="mixed",
                    help="serve mode: mixed t2i/i2i lanes, or the repeated-prompt cache row")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--preset", choices=list(PRESETS), default=None,
                    help="BASELINE.md target configs 1-5")
    ap.add_argument("--mesh", default=None,
                    help="axis sizes, e.g. 'dp=2', 'sp=2' or 'tp=2' (image mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain PyTorch versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    preset = PRESETS.get(args.preset)
    if args.impl is None:
        args.impl = preset["impl"] if preset else "q8t"
    if args.mode == "serve":
        return bench_serve(args, preset)
    # the bf16 streamed preset has a step-mode harness only
    if args.mode == "step" or args.preset == "dev-1024-bf16":
        return bench_step(args, preset)
    return bench_image(args, preset)


if __name__ == "__main__":
    sys.exit(main())
