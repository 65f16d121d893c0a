"""FLUX text-to-image, img2img and inpainting pipeline (port of
``pipelines/flux_pipeline.py``): tokenize + pad both encoders, T5 + CLIP
encode, seeded latent noise, patchify + position ids, resolution shift mu,
Euler denoise, unpack, VAE scale/shift + decode (one shot, or tiled above a
128-pixel latent side; batch-chunked), (clamp + 1) * 127.5 -> u8.

With ``init_image`` the image is resized (PIL, LANCZOS) to the rounded
resolution, VAE-encoded (one shot, or tiled past the same threshold) with a
seeded Gaussian sample, scaled, and the schedule truncated to
``round(num_steps * strength)`` steps, starting from
``sig0 * noise + (1 - sig0) * latent``; with ``mask_image`` (white =
repaint, BILINEAR to the latent size) every step pins the unmasked tokens to
the init latent renoised to the step's sigma. A u8 image already at the
rounded size, or a u8 mask at the latent size, needs no resize and so no
Pillow.

The JAX stage seams stay methods (``_encode``, ``_encode_image``,
``_denoise``, ``_decode``), so tests can inject the same noise into both
packages. They are also the offload seams: with ``offload``
(parallel.HostOffload, ``Offloading.Full``) each stage acquires its
components' device copies and releases them when it ends (``_resident``,
the JAX pipeline's ``_component`` / ``_release``); with
``streamed`` (models/flux_streaming.StreamedFlux, ``Offloading.Stream``)
the denoise streams the transformer's blocks from host memory
(``_denoise_streamed``; img2img passes its start latent in as the noise,
inpainting raises).

The stages run inside the JAX pipeline's named spans (util/tracing.py:
``text-encode``, ``denoise``, ``vae-decode``, ``vae-encode``,
``vae-encode-tiled``), and ``forward_arrays`` inside
``maybe_profile("generate")``, which writes a profiler trace when
DIFFUSION_RS_TPU_TRACE_DIR is set.

Under a mesh (``parallel.make_mesh``; one process per rank, SPMD) every
rank tokenizes the whole batch and encodes its dp rows, draws the whole
batch's noise (and encoder sample) from the seed and keeps its dp rows,
prepares the whole batch's init images and mask on the host and
VAE-encodes its dp rows, packs them and keeps its sp rows of the image
tokens (and of the inpaint planes) through the Euler loop (the update is
per token), then gathers the whole latent over sp and dp before the
decode, so that ``forward_arrays`` returns the same images on every rank.
Under ``tp`` the ranks of one (dp, sp) position hold their own slices of
the FLUX and T5 weights (the constructor cuts whole trees with
parallel/sharding.shard_flux_t5), run the same rows, and sum
each row-parallel product over the tp group, so they hold the same
activations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..io.tokenizer import tokenize_and_pad
from ..models.clip import ClipTextConfig, clip_encode
from ..models.flux import FluxConfig, compute_pe, flux_forward
from ..models.t5 import T5Config, t5_encode
from ..models.vae import VAEConfig, vae_decode, vae_decode_tiled, vae_encode, vae_encode_tiled
from ..ops import _cuda
from ..parallel.mesh import Sharding, batch_sharding, sequence_sharding
from ..util.capacity import check_denoise_capacity
from ..util.device import resolve_device
from ..util.tracing import maybe_profile, trace_span, warn_once
from .sampling import (
    denoise,
    get_encode_noise,
    get_noise,
    latent_hw,
    make_img_ids,
    make_txt_ids,
    pack_latents,
    unpack_latents,
)
from .scheduler import SchedulerConfig, calculate_shift

T5_LEN_SCHNELL = 256
T5_LEN_DEV = 512
CLIP_MAX_LEN = 77


@dataclasses.dataclass
class DiffusionGenerationParams:
    height: int = 720
    width: int = 1280
    num_steps: int = 50
    guidance_scale: float = 3.5
    seed: Optional[int] = None  # None draws a time-based seed
    max_sequence_length: Optional[int] = None  # T5 pad length override


def _import_pil():
    """Pillow, imported when an image or mask needs a resize."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("resizing an init image or mask needs Pillow (pip install "
                          "Pillow); pass a u8 [H, W, 3] image at the rounded size and "
                          "a u8 [h, w] mask at the latent size to skip it") from e
    return Image


class FluxPipeline:
    """Holds the four components' params on one device. ``device`` defaults
    to CUDA (under a ``mesh``, the rank's card) and raises when CUDA is
    absent. With ``mesh``, every rank builds the pipeline on the same whole
    params; where the mesh's tp > 1, the constructor cuts FLUX and T5 to
    this rank's slices (parallel/sharding.shard_flux_t5) and moves them to
    the device unless ``offload`` holds them, so that whole trees built in
    host memory never lie whole on the card.

    ``t5_mask_pads`` (masks T5's pad keys out of attention; the reference
    attends them) and ``step_progress`` (one line per denoise step) resolve
    once here, from DIFFUSION_RS_TPU_T5_MASK_PADS=1 / DIFFUSION_RS_TPU_PROGRESS
    when None, and are read-only after, as in JAX.

    ``offload`` (parallel.HostOffload) takes the host copies of ``t5``,
    ``clip``, ``vae`` and, unless ``streamed`` (a StreamedFlux, with
    ``flux_params`` None) holds the transformer, ``flux``; the pipeline
    keeps the trees ``register`` returns. ``streamed`` with a ``mesh``
    raises ``ValueError``."""

    def __init__(self, *, flux_params, flux_cfg: FluxConfig, t5_params,
                 t5_cfg: T5Config, clip_params, clip_cfg: ClipTextConfig,
                 vae_params, vae_cfg: VAEConfig, scheduler: SchedulerConfig,
                 t5_tokenizer, clip_tokenizer, dtype=torch.bfloat16,
                 device="cuda", mesh=None, t5_mask_pads=None, step_progress=None,
                 offload=None, streamed=None):
        if mesh is not None and streamed is not None:
            raise ValueError("mesh and Offloading.Stream are mutually exclusive")
        self.device = resolve_device(device)
        if mesh is not None and self.device.type == "cuda":
            self.device = mesh.device
        self.mesh = mesh
        if mesh is not None and mesh.shape["tp"] > 1:
            # each rank keeps its own slices of FLUX and T5, on the device
            # unless offloaded (a rank's cut of a tree built in host memory
            # is the only part that reaches its card)
            from ..parallel.sharding import shard_flux_t5

            flux_params, t5_params = shard_flux_t5(
                flux_params, flux_cfg, t5_params, t5_cfg, mesh,
                device=None if offload is not None else self.device)
        self.flux_params = flux_params
        self.flux_cfg = flux_cfg
        self.t5_params = t5_params
        self.t5_cfg = t5_cfg
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        self.scheduler = scheduler
        self.t5_tokenizer = t5_tokenizer
        self.clip_tokenizer = clip_tokenizer
        self.dtype = dtype
        self._t5_mask_pads = bool(
            t5_mask_pads if t5_mask_pads is not None
            else os.environ.get("DIFFUSION_RS_TPU_T5_MASK_PADS") == "1")
        self._step_progress = bool(
            step_progress if step_progress is not None
            else os.environ.get("DIFFUSION_RS_TPU_PROGRESS"))
        self.offload = offload
        self.streamed = streamed
        if offload is not None:
            for name in ("t5", "clip", "flux", "vae"):
                if name != "flux" or flux_params is not None:
                    attr = f"{name}_params"
                    setattr(self, attr, offload.register(name, getattr(self, attr),
                                                         device=self.device))
        # Stage wall times of the last forward_arrays call, in seconds
        # (encode, init-image encode, per denoise step, decode), each ending
        # in a device sync; with each step's host launch time and the
        # denoise's launch wrapper time (_euler).
        self.timings: dict = {}

    @property
    def t5_mask_pads(self) -> bool:
        """Frozen at construction."""
        return self._t5_mask_pads

    @property
    def step_progress(self) -> bool:
        """Frozen at construction."""
        return self._step_progress

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # -- component residency (offload seams) ------------------------------------

    @contextlib.contextmanager
    def _resident(self, name: str):
        """The component's params on the device for the block's duration (the
        JAX pipeline's ``_component`` / ``_release`` pair)."""
        if self.offload is None or not self.offload.manages(name):
            yield getattr(self, f"{name}_params")
            return
        try:
            yield self.offload.resident(name)
        finally:
            self.offload.release(name)

    # -- stages ---------------------------------------------------------------

    @torch.no_grad()
    def _encode(self, t5_ids: torch.Tensor, clip_ids: torch.Tensor):
        with (trace_span("text-encode"), self._resident("t5") as t5,
              self._resident("clip") as clip):
            txt = t5_encode(t5, self.t5_cfg, t5_ids, mask_pads=self._t5_mask_pads).to(self.dtype)
            _, y = clip_encode(clip, self.clip_cfg, clip_ids)
        return txt, y.to(self.dtype)

    @torch.no_grad()
    def _denoise(self, txt, y, sigmas: np.ndarray, guidance, noise, inpaint=None):
        """The Euler loop over ``noise`` [B, 16, h, w] (this rank's dp rows
        under a mesh), with the packed ``inpaint`` planes (mask, init, noise)
        when given; returns the packed latent, this rank's sp rows."""
        dt = self.dtype
        bs = txt.shape[0]
        img = pack_latents(noise.to(dt))
        if self.mesh is not None:  # this rank's image rows, and the planes'
            rows = Sharding(self.mesh, (None, "sp"))
            img = rows.local(img)
            if inpaint is not None:
                inpaint = tuple(rows.local(p) for p in inpaint)
        pe = self._pe(txt, noise)
        with self._resident("flux") as flux:
            def step(x, t):
                t_vec = torch.full((bs,), t, dtype=torch.float32, device=x.device)
                return flux_forward(flux, self.flux_cfg, x.to(dt), txt, t_vec, y, guidance,
                                    pe=pe, mesh=self.mesh)

            with trace_span("denoise"):
                return self._euler(step, img, sigmas, inpaint)

    @torch.no_grad()
    def _denoise_streamed(self, txt, y, sigmas: np.ndarray, guidance, noise):
        """:meth:`_denoise` with the transformer's blocks streamed from host
        memory (``Offloading.Stream``; models/flux_streaming.py)."""
        dt = self.dtype
        pe = self._pe(txt, noise)
        with trace_span("denoise"):
            return self._euler(
                lambda x, t: self.streamed.predict(x.to(dt), txt, t, y, guidance, pe),
                pack_latents(noise.to(dt)), sigmas, None)

    def _pe(self, txt, noise):
        """RoPE tables of the joint sequence for ``noise`` [B, 16, h, w]."""
        bs, h2, w2 = txt.shape[0], noise.shape[2] // 2, noise.shape[3] // 2
        return compute_pe(self.flux_cfg, make_txt_ids(bs, txt.shape[1], txt.device),
                          make_img_ids(bs, h2, w2, txt.device))

    def _euler(self, step, img, sigmas: np.ndarray, inpaint):
        """pipelines/sampling.denoise with, per step, the wall time ending in
        a device sync (``timings["steps_s"]``) and the host time until the
        step's Euler update returned, before that sync
        (``timings["steps_host_s"]``): their difference is the work the
        device still had queued when the host had launched the step. Also
        ``timings["launch_wrapper_s"]``: the kernel launches' wrapper time
        over the denoise (ops/_cuda.launch_wrapper_ns, every thread's)."""
        steps, host = [], []
        wrapper0 = _cuda.launch_wrapper_ns()
        last = [self._sync()]

        def on_step(i):
            launched = time.perf_counter()
            now = self._sync()
            host.append(launched - last[0])
            steps.append(now - last[0])
            last[0] = now

        first_rank = self.mesh is None or not any(self.mesh.coords.values())
        out = denoise(step, img, sigmas, on_step=on_step, inpaint=inpaint,
                      progress=self._step_progress and first_rank)
        self.timings["steps_s"] = steps
        self.timings["steps_host_s"] = host
        self.timings["launch_wrapper_s"] = (_cuda.launch_wrapper_ns() - wrapper0) * 1e-9
        return out

    def _pre_decode(self, latent, height: int, width: int):
        latent = unpack_latents(latent, height, width)
        z = latent / self.vae_cfg.scaling_factor + self.vae_cfg.shift_factor
        return z.permute(0, 2, 3, 1).to(self.dtype)  # NHWC

    @staticmethod
    def _to_u8(img_out):
        x = (torch.clamp(img_out.float(), -1.0, 1.0) + 1.0) * 127.5
        return torch.clamp(x, 0, 255).to(torch.uint8)

    @torch.no_grad()
    def _decode(self, latent, height: int, width: int):
        z = self._pre_decode(latent, height, width)
        with self._resident("vae") as vae:
            return self._to_u8(vae_decode(vae, self.vae_cfg, z))

    # Above this latent side the decode runs in tiles (the JAX package's
    # threshold, where its one-shot decode outgrew a 16 GB TPU); tile size
    # from DIFFUSION_RS_TPU_VAE_TILE (latent pixels; 0 disables tiling).
    _TILE_DECODE_ABOVE = 128

    @torch.no_grad()
    def _decode_any(self, latent, height: int, width: int):
        """One-shot decode, or :func:`vae_decode_tiled` when the latent's
        longer side exceeds ``_TILE_DECODE_ABOVE``."""
        tile = int(os.environ.get("DIFFUSION_RS_TPU_VAE_TILE", "128"))
        with trace_span("vae-decode"):
            if tile <= 0 or max(latent_hw(height, width)) <= self._TILE_DECODE_ABOVE:
                return self._decode(latent, height, width)
            z = self._pre_decode(latent, height, width)
            with self._resident("vae") as vae:
                return self._to_u8(vae_decode_tiled(vae, self.vae_cfg, z, tile=tile))

    @torch.no_grad()
    def _encode_image(self, x_nhwc, eps):
        """Image [-1, 1] NHWC -> scaled NCHW latent (the img2img init)."""
        with trace_span("vae-encode"), self._resident("vae") as vae:
            return self._scale_latent(vae_encode(vae, self.vae_cfg, x_nhwc, eps))

    def _scale_latent(self, lat):
        z = (lat - self.vae_cfg.shift_factor) * self.vae_cfg.scaling_factor
        return z.permute(0, 3, 1, 2)  # NCHW [B, 16, h, w]

    @torch.no_grad()
    def _encode_image_any(self, x_nhwc, eps):
        """One-shot encode, or :func:`vae_encode_tiled` when the image's
        longer side exceeds ``_TILE_DECODE_ABOVE`` times the encoder stride
        (tiles of DIFFUSION_RS_TPU_VAE_TILE latent pixels), as the decode."""
        tile = int(os.environ.get("DIFFUSION_RS_TPU_VAE_TILE", "128"))
        f = 2 ** (len(self.vae_cfg.block_out_channels) - 1)
        if tile <= 0 or max(x_nhwc.shape[1:3]) <= self._TILE_DECODE_ABOVE * f:
            return self._encode_image(x_nhwc, eps)
        with trace_span("vae-encode-tiled"), self._resident("vae") as vae:
            return self._scale_latent(vae_encode_tiled(vae, self.vae_cfg, x_nhwc, eps,
                                                       tile=tile * f))

    def _prepare_image_batch(self, image, b: int, params) -> torch.Tensor:
        """Init image(s) (PIL images or u8 arrays; one, or one per prompt) ->
        [-1, 1] NHWC in the pipeline dtype at the rounded resolution, on the
        host. PIL resizes (LANCZOS) all but u8 [H, W, 3] arrays at that
        size, which PIL would return unchanged."""
        H = (params.height + 15) // 16 * 16
        W = (params.width + 15) // 16 * 16
        imgs = list(image) if isinstance(image, (list, tuple)) else [image] * b
        if len(imgs) != b:
            raise ValueError(f"got {len(imgs)} init images for {b} prompts")
        out = []
        for im in imgs:
            if not (isinstance(im, np.ndarray) and im.dtype == np.uint8
                    and im.shape == (H, W, 3)):
                Image = _import_pil()
                if not isinstance(im, Image.Image):
                    im = Image.fromarray(np.asarray(im))
                im = im.convert("RGB").resize((W, H), Image.LANCZOS)
            out.append(np.asarray(im, np.float32) / 127.5 - 1.0)
        return torch.from_numpy(np.stack(out)).to(self.dtype)

    def _prepare_mask(self, mask_image, b: int, params) -> torch.Tensor:
        """Mask (PIL image or array; white = repaint) -> packed [B, S, 64] f32
        on the host, in the packed latent's channel order c*4 + ph*2 + pw:
        the 1-channel map at the latent size packed to [B, S, 4], tiled 16
        times. PIL resizes (BILINEAR, grey) all but a u8 [h, w] array at the
        latent size."""
        h, w = latent_hw(params.height, params.width)
        m = mask_image
        if not (isinstance(m, np.ndarray) and m.dtype == np.uint8 and m.shape == (h, w)):
            Image = _import_pil()
            if not isinstance(m, Image.Image):
                m = Image.fromarray(np.asarray(m))
            m = m.convert("L").resize((w, h), Image.BILINEAR)
        m = np.asarray(m, np.float32)[None, None] / 255.0  # [1, 1, h, w]
        packed = pack_latents(torch.from_numpy(np.repeat(m, b, axis=0)))  # [B, S, 4]
        return packed.repeat(1, 1, 16)

    def _decode_chunk(self, n: int, params) -> int:
        """Samples per decode call: DIFFUSION_RS_TPU_DECODE_CHUNK, else the
        whole batch under a mesh, else about 1M decoded pixels."""
        chunk = os.environ.get("DIFFUSION_RS_TPU_DECODE_CHUNK")
        if chunk is not None:
            return max(1, int(chunk))
        if self.mesh is not None:
            return n
        px = ((params.height + 15) // 16 * 16) * ((params.width + 15) // 16 * 16)
        return max(1, (1 << 20) // max(1, px))

    def _sigmas(self, params) -> np.ndarray:
        """The flow-match schedule. The resolution shift's sequence argument
        is the packed-patch count, or with DIFFUSION_RS_TPU_REFERENCE_MU=1 the
        latent channel count (the reference's quirk), as in JAX."""
        if os.environ.get("DIFFUSION_RS_TPU_REFERENCE_MU") == "1":
            seq_arg = self.vae_cfg.latent_channels
        else:
            seq_arg = ((params.height + 15) // 16) * ((params.width + 15) // 16)
        mu = calculate_shift(seq_arg, self.scheduler.base_image_seq_len,
                             self.scheduler.max_image_seq_len,
                             self.scheduler.base_shift, self.scheduler.max_shift)
        return self.scheduler.timesteps(
            params.num_steps, mu=mu if self.scheduler.use_dynamic_shifting else None)

    def _check_capacity(self, params, batch: int, txt_tokens: int) -> None:
        """The JAX pipeline's static check before the resident denoise
        (util/capacity.py): raises when the transformer's weights alone
        exceed the device's memory, warns once when the activation estimate
        takes them over it. On a CPU device it runs only where
        DIFFUSION_RS_TPU_HBM_BYTES sets a budget; a streamed denoise skips
        it, as in JAX."""
        if self.device.type != "cuda" and not os.environ.get("DIFFUSION_RS_TPU_HBM_BYTES"):
            return
        img_tokens = ((params.height + 15) // 16) * ((params.width + 15) // 16)
        tp = 1 if self.mesh is None else self.mesh.shape["tp"]
        msg = check_denoise_capacity(self.flux_params, batch=batch, img_tokens=img_tokens,
                                     txt_tokens=txt_tokens, hidden=self.flux_cfg.hidden_size,
                                     tp=tp, device=self.device)
        if msg:
            warn_once(f"capacity-{params.height}x{params.width}-{batch}", msg)

    # -- front end --------------------------------------------------------------

    def forward_arrays(self, prompts: List[str], params, init_image=None,
                       strength: float = 0.6, mask_image=None,
                       output_type: str = "np") -> np.ndarray:
        """u8 NHWC images [B, H, W, 3]; ``output_type="latent"`` returns the
        packed post-denoise f32 latent [B, S, 64] instead.

        ``init_image`` (PIL image or u8 array, or a list of them, one per
        prompt) switches to img2img: ``strength`` in (0, 1] is the share of
        the schedule run (1.0 ignores the image). ``mask_image`` (white =
        repaint) with it inpaints. With DIFFUSION_RS_TPU_TRACE_DIR set, the
        call is profiled into that directory (util/tracing.maybe_profile)."""
        with maybe_profile("generate"):
            return self._forward_arrays(prompts, params, init_image, strength, mask_image,
                                        output_type)

    def _forward_arrays(self, prompts, params, init_image, strength, mask_image,
                        output_type) -> np.ndarray:
        if output_type not in ("np", "latent"):
            raise ValueError(f"output_type must be 'np' or 'latent', got {output_type!r}")
        n = len(prompts)
        if mask_image is not None and init_image is None:
            raise ValueError("mask_image requires init_image (inpainting)")
        if init_image is not None:
            if not 0.0 < strength <= 1.0:
                raise ValueError(f"strength must be in (0, 1], got {strength}")
            x_init = self._prepare_image_batch(init_image, n, params)
            mask = None if mask_image is None else self._prepare_mask(mask_image, n, params)
        dev = self.device
        t5_len = params.max_sequence_length or (
            T5_LEN_DEV if self.flux_cfg.guidance_embeds else T5_LEN_SCHNELL)
        t5_ids = tokenize_and_pad(prompts, self.t5_tokenizer, pad_to=t5_len)
        clip_ids = tokenize_and_pad(prompts, self.clip_tokenizer)
        if clip_ids.shape[1] > CLIP_MAX_LEN:
            warnings.warn(
                f"CLIP prompt is {clip_ids.shape[1]} tokens; truncating to "
                f"{CLIP_MAX_LEN} — pooled conditioning uses argmax(token id) "
                "over the truncated window", stacklevel=2)
            clip_ids = clip_ids[:, :CLIP_MAX_LEN]

        t5_ids, clip_ids = torch.from_numpy(t5_ids), torch.from_numpy(clip_ids)
        seed = params.seed if params.seed is not None else time.time_ns() % (1 << 31)
        noise = get_noise(seed, n, params.height, params.width, dev)
        rows = None
        if self.mesh is not None:  # this rank's dp rows of the whole batch
            if n % self.mesh.shape["dp"]:
                raise ValueError(f"a batch of {n} does not split over dp={self.mesh.shape['dp']}")
            rows = batch_sharding(self.mesh)
            t5_ids, clip_ids, noise = rows.local(t5_ids), rows.local(clip_ids), rows.local(noise)

        self.timings = {}
        t0 = self._sync()
        txt, y = self._encode(t5_ids.to(dev), clip_ids.to(dev))
        t1 = self._sync()
        self.timings["encode_s"] = t1 - t0

        sigmas = self._sigmas(params)
        inpaint = None
        if init_image is not None:
            # Truncate the schedule (diffusers FluxImg2ImgPipeline
            # get_timesteps) and start from the interpolated latent.
            steps_run = max(1, min(int(round(params.num_steps * strength)), params.num_steps))
            sigmas = sigmas[params.num_steps - steps_run:]
            h, w = latent_hw(params.height, params.width)
            eps = get_encode_noise(seed, (n, h, w, self.vae_cfg.latent_channels),
                                   self.dtype, dev)
            if rows is not None:
                x_init, eps = rows.local(x_init), rows.local(eps)
                mask = None if mask is None else rows.local(mask)
            lat = self._encode_image_any(x_init.to(dev), eps)
            t_img = self._sync()
            self.timings["image_encode_s"] = t_img - t1
            t1 = t_img
            sig0 = float(sigmas[0])
            pure_noise = noise
            noise = sig0 * noise + (1.0 - sig0) * lat.float()
            if mask is not None:
                if self.streamed is not None:
                    raise NotImplementedError(
                        "inpainting with Offloading.Stream is not supported")
                inpaint = (mask.to(dev), pack_latents(lat.float()),
                           pack_latents(pure_noise.float()))
        guidance = (
            torch.full((txt.shape[0],), params.guidance_scale, dtype=torch.float32,
                       device=dev)
            if self.flux_cfg.guidance_embeds else None
        )
        if self.streamed is not None:
            latent = self._denoise_streamed(txt, y, sigmas, guidance, noise)
        else:
            self._check_capacity(params, n, txt.shape[1])
            latent = self._denoise(txt, y, sigmas, guidance, noise, inpaint)
        if self.mesh is not None:  # the whole latent on every rank
            h2, w2 = noise.shape[2] // 2, noise.shape[3] // 2
            latent = sequence_sharding(self.mesh).gather(latent, (n, h2 * w2, latent.shape[2]))
        t2 = self._sync()
        self.timings["denoise_s"] = t2 - t1
        if output_type == "latent":
            return latent.float().cpu().numpy()
        chunk = self._decode_chunk(n, params)
        out = np.concatenate([self._decode_any(latent[i:i + chunk], params.height,
                                               params.width).cpu().numpy()
                              for i in range(0, n, chunk)])
        self.timings["decode_s"] = self._sync() - t2
        return out

    def img2img(self, prompts: List[str], params, image, strength: float = 0.6
                ) -> List[np.ndarray]:
        """Image-to-image: one u8 ``[H, W, 3]`` array per prompt (see
        :meth:`forward_arrays`)."""
        arr = self.forward_arrays(prompts, params, init_image=image, strength=strength)
        return [arr[i] for i in range(arr.shape[0])]

    def inpaint(self, prompts: List[str], params, image, mask, strength: float = 1.0
                ) -> List[np.ndarray]:
        """Inpainting: repaint the white region of ``mask`` guided by the
        prompt, the rest pinned to the renoised init latent every step
        (diffusers FluxInpaintPipeline construction); ``strength`` as in
        img2img. One u8 ``[H, W, 3]`` array per prompt."""
        arr = self.forward_arrays(prompts, params, init_image=image, strength=strength,
                                  mask_image=mask)
        return [arr[i] for i in range(arr.shape[0])]
