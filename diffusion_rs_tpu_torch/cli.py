"""Interactive CLI front end (port of the JAX package's ``cli.py``).

The reference binary's flags (diffusion_rs_cli/src/main.rs:30-144):
a source (``--dduf FILE`` | ``--model-id ID``), ``--scale --num-steps
--offloading --dtype --token --revision``, then an interactive loop asking
height, width, prompt and save path per image; ``--prompt`` generates once.
``--serve`` starts the continuous-batching HTTP server (serving.py). The
port adds ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions) and writes the PNG bytes of ``Pipeline.forward`` (no Pillow;
``--init-image`` / ``--mask-image`` files are decoded with it).

Usage:
    python -m diffusion_rs_tpu_torch.cli --model-id <id-or-dir> [--num-steps 50 ...]
    python -m diffusion_rs_tpu_torch.cli --dduf model.dduf --prompt "..." -o out.png
    python -m diffusion_rs_tpu_torch.cli --model-id <dir> --serve --port 8000
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    from .quant.isq import SUPPORTED as _ISQ

    p = argparse.ArgumentParser(
        prog="diffusion_rs_tpu_torch",
        description="Diffusion inference on an NVIDIA GPU (FLUX.1 dev/schnell)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-m", "--model-id", help="HF model id or local directory")
    src.add_argument("-f", "--dduf", help="path to a .dduf archive")
    p.add_argument("--transformer-model-id", default=None,
                   help="override source for the transformer (quantized repo or a "
                        "single-file .gguf)")
    p.add_argument("--scale", type=float, default=3.5, help="guidance scale")
    p.add_argument("--num-steps", type=int, default=50)
    p.add_argument("--offloading", choices=["full", "stream"], default=None)
    p.add_argument("--dtype", choices=["auto", "bf16", "f16", "f32"], default="auto")
    p.add_argument("--isq", choices=list(_ISQ), default=None,
                   help="in-situ quantize dense transformer + T5 linears")
    p.add_argument("--isq-t5", choices=list(_ISQ), default=None,
                   help="override the T5 encoder's ISQ format (default: follow --isq, "
                        "capacity-guarded)")
    p.add_argument("--imatrix", default=None, metavar="FILE",
                   help="importance-matrix file (llama.cpp format) for --isq")
    p.add_argument("--lora", action="append", default=None, metavar="FILE",
                   help="FLUX LoRA safetensors to apply (repeatable)")
    p.add_argument("--lora-scale", action="append", type=float, default=None,
                   help="scale per --lora (repeatable; default 1.0 each)")
    p.add_argument("--token", default=None)
    p.add_argument("--revision", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--prompt", default=None,
                   help="non-interactive: generate once and exit")
    p.add_argument("--init-image", default=None, metavar="FILE",
                   help="img2img: start from this image instead of noise")
    p.add_argument("--strength", type=float, default=None,
                   help="denoise strength in (0, 1] (default 0.6 for img2img, 1.0 for "
                        "inpainting)")
    p.add_argument("--mask-image", default=None, metavar="FILE",
                   help="inpainting mask (white = repaint); requires --init-image")
    p.add_argument("-o", "--out", default="image.png")
    p.add_argument("--serve", action="store_true",
                   help="start the continuous-batching HTTP server (POST /generate, "
                        "GET /metrics, GET /healthz)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--request-timeout", type=float, default=None, metavar="S",
                   help="per-request serving timeout in seconds")
    p.add_argument("--max-batch", type=int, default=4,
                   help="serving lanes sharing each batched forward")
    p.add_argument("--fuse", default=None, metavar="STREAMS",
                   help="projection groups to fuse into one wide call each: comma subset "
                        "of img,txt,single,t5,grouped, or 'all' (default none)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="directory the CUDA kernels are built into and loaded from "
                        "(DIFFUSION_RS_TPU_COMPILE_CACHE), kept across processes")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch versions)")
    p.add_argument("--silent", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING if args.silent else logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")

    from .pipelines.api import (
        DiffusionGenerationParams,
        ModelDType,
        ModelSource,
        Offloading,
        Pipeline,
        decode_image,
    )

    source = (ModelSource.dduf(args.dduf) if args.dduf
              else ModelSource.from_model_id(args.model_id, args.transformer_model_id))
    pipe = Pipeline(
        source,
        silent=args.silent,
        token=args.token,
        revision=args.revision,
        offloading={"full": Offloading.Full, "stream": Offloading.Stream}.get(args.offloading),
        dtype=ModelDType(args.dtype),
        isq=args.isq,
        isq_t5=args.isq_t5,
        imatrix=args.imatrix,
        lora=args.lora,
        lora_scale=(args.lora_scale if args.lora_scale is not None
                    else [1.0] * len(args.lora or [])) or 1.0,
        compile_cache=args.compile_cache,
        fuse=args.fuse,
        device=args.device,
    )

    def generate(prompt: str, height: int, width: int, out_path: str):
        params = DiffusionGenerationParams(height=height, width=width,
                                           num_steps=args.num_steps,
                                           guidance_scale=args.scale, seed=args.seed)
        t0 = time.time()
        if args.init_image:
            init = decode_image(Path(args.init_image).read_bytes())
            if args.mask_image:
                mask = decode_image(Path(args.mask_image).read_bytes())
                strength = 1.0 if args.strength is None else args.strength
                png = pipe.inpaint([prompt], params, init, mask, strength)[0]
            else:
                strength = 0.6 if args.strength is None else args.strength
                png = pipe.img2img([prompt], params, init, strength)[0]
        else:
            png = pipe.forward([prompt], params)[0]
        print(f"Took: {time.time() - t0:.2f}s")
        Path(out_path).write_bytes(png)
        print(f"Saved to {out_path}")

    if args.serve:
        from .serving import FluxServer, serve_http

        server = FluxServer(pipe._inner, max_batch=args.max_batch,
                            request_timeout_s=args.request_timeout)
        print(f"serving on http://{args.host}:{args.port} "
              f"(POST /generate, GET /metrics, GET /healthz)")
        try:
            serve_http(server, args.host, args.port)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        return 0

    if args.prompt is not None:
        generate(args.prompt, args.height, args.width, args.out)
        return 0

    # interactive loop (main.rs:97-143)
    print("Interactive mode — Ctrl-C/empty prompt to exit.")
    n = 0
    while True:
        try:
            h = input(f"Height [{args.height}]: ").strip()
            w = input(f"Width [{args.width}]: ").strip()
            prompt = input("Prompt: ").strip()
            if not prompt:
                return 0
            out = input(f"Save path [image_{n}.png]: ").strip() or f"image_{n}.png"
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        generate(prompt, int(h or args.height), int(w or args.width), out)
        n += 1


if __name__ == "__main__":
    sys.exit(main())
