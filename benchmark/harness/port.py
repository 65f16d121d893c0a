"""The system under test: the port's ``FluxPipeline`` (and ``FluxServer``)
built on the benchmark's planes. The only module of the harness that imports
the program, through its public entry points and containers."""

from __future__ import annotations

import torch

from .planes import NF4, Q8, Cv, Lin, WordTokenizer


def _wrap(node):
    """Planes -> the port's containers (the same tensors, no copy)."""
    from diffusion_rs_tpu_torch.ops.conv import Conv
    from diffusion_rs_tpu_torch.ops.linear import Linear
    from diffusion_rs_tpu_torch.quant.qtensor import QuantizedTensor

    def w(x):
        if isinstance(x, Q8):
            k, n = x.codes.shape[-2:]
            return QuantizedTensor(packed=x.codes, scale=x.scale, bias=None, codebook=None,
                                   kind="q8t", bits=8, group=x.group, split=_split(k),
                                   shape=(k, n), out_dtype="bfloat16")
        if isinstance(x, NF4):
            k2, n = x.packed.shape[-2:]
            return QuantizedTensor(packed=x.packed, scale=x.scale, bias=None,
                                   codebook=x.codebook, kind="nf4", bits=4, group=x.group,
                                   split=x.split, shape=(2 * k2, n), out_dtype="bfloat16")
        return x

    if isinstance(node, Lin):
        return Linear(w=w(node.w), b=node.b)
    if isinstance(node, Cv):
        return Conv(w=node.w, b=node.b)
    if isinstance(node, dict):
        return {k: _wrap(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_wrap(v) for v in node]
    return node


def _split(k: int) -> int:
    from diffusion_rs_tpu_torch.quant.qtensor import choose_split

    return choose_split(k)


def build_kernels() -> float:
    """Build the port's kernel libraries that the checkout lacks (its fixed
    build directory); the seconds it took, about 0 once they are there."""
    import time

    from diffusion_rs_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    return time.perf_counter() - t0


def configs(cfg: dict):
    """The port's config objects from a configuration file."""
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig
    from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig

    return dict(
        flux_cfg=FluxConfig.from_json(cfg),
        t5_cfg=T5Config.from_json(cfg["text_encoder_2"]),
        clip_cfg=ClipTextConfig.from_json(cfg["text_encoder"]),
        vae_cfg=VAEConfig.from_json(cfg["vae"]),
        scheduler=SchedulerConfig.from_json(cfg["scheduler"]),
    )


def build_pipeline(cfg: dict, planes: dict, device):
    """``FluxPipeline`` on the planes, in the configuration's activation dtype."""
    from diffusion_rs_tpu_torch.pipelines.flux_pipeline import FluxPipeline

    c = configs(cfg)
    return FluxPipeline(
        flux_params=_wrap(planes["flux"]), t5_params=_wrap(planes["t5"]),
        clip_params=_wrap(planes["clip"]), vae_params=_wrap(planes["vae"]),
        t5_tokenizer=WordTokenizer(cfg["text_encoder_2"]["vocab_size"]),
        clip_tokenizer=WordTokenizer(cfg["text_encoder"]["vocab_size"]),
        dtype=getattr(torch, cfg["formats"]["activations"]), device=device,
        t5_mask_pads=False, step_progress=False, **c)


def generation_params(cfg: dict, height: int, width: int, seed: int, num_steps=None):
    from diffusion_rs_tpu_torch.pipelines.flux_pipeline import DiffusionGenerationParams

    g = cfg["generation"]
    return DiffusionGenerationParams(
        height=height, width=width, num_steps=num_steps or g["num_steps"],
        guidance_scale=g["guidance_scale"], seed=seed,
        max_sequence_length=g["max_sequence_length"])


def server(pipe, **kwargs):
    from diffusion_rs_tpu_torch.serving import FluxServer

    return FluxServer(pipe, **kwargs)


class LatentTap:
    """The packed post-denoise latent of each image the timed path decodes,
    taken where the program hands it to its VAE decode (``_decode_any``,
    which the pipeline and the server's decode thread both call), so that the
    check can hold the denoise to the reference apart from the decode and
    the u8 rounding. It holds a reference to the program's tensor (which
    nothing writes once it is decoded) and copies it to the host only after
    the image is back, so it adds no synchronisation to the path."""

    def __init__(self, pipe):
        self._real = pipe._decode_any
        self.last = None
        pipe._decode_any = self._decode_any

    def _decode_any(self, latent, height, width):
        self.last = latent
        return self._real(latent, height, width)

    def take(self):
        """The last decoded latent on the host, f32 [S, C] (closed loop)."""
        lat, self.last = self.last, None
        return None if lat is None else lat.float().cpu()[0]


class ServerTap:
    """What the check needs from the server's timed path: each finished
    lane's packed latent by its request's Future (the server's ``_retire``, on
    its decode thread, is wrapped to keep the lane's latent, copied to the
    host once the image is set), and the Futures of the lanes that each
    batched forward of two or more lanes stepped together (``_batch``), so
    that the check can judge a whole batch."""

    def __init__(self, server):
        self.latents = {}
        self.batches = []
        retire, batch = server._retire, server._batch

        def _retire(ln):
            lat = ln.latent
            retire(ln)
            self.latents[ln.future] = lat.float().cpu()

        def _batch(lanes, bucket):
            if len(lanes) > 1:
                self.batches.append(tuple(ln.future for ln in lanes))
            return batch(lanes, bucket)

        server._retire, server._batch = _retire, _batch
