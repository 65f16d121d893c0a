"""Serving mode: a request queue and continuous batching over the denoise
loop (port of the JAX package's ``serving.py``).

The flow-matching MMDiT forward takes the timestep per batch element
(``t [B]``, models/flux.flux_forward) and the Euler update is per element
(``x += pred * dt``), so requests that arrived at different times, and sit
at different denoise steps, share one batched forward: each lane carries
its own (latent, txt, y, t, dt). A lane finishes when its schedule is
exhausted and its place is refilled from the queue on the next tick,
without waiting for the rest of the batch.

Lanes are grouped by (latent h/2, latent w/2, text length), so one server
serves mixed resolutions and prompt lengths (each group ticks its own
forward). Batches are padded to power-of-two buckets with copies of lane 0
at ``dt = 0`` (a no-op update): the kernels see at most log2(max_batch) + 1
batch shapes per group, and a lone request does not pay a max_batch
forward. ``stats()`` / ``metrics_text()`` export occupancy, queue depth,
latency and step counters (Prometheus text, ``drs_server_*``).

The port's design:

- **Step.** A plain call of ``flux_forward`` with ``t [B]`` per lane
  (JAX jits it); the CUDA kernels run at the bucket's batch.
- **Threads and streams.** A request is encoded (T5 + CLIP, and an
  img2img lane's VAE encode) on the thread that submits it, the batched
  steps run on the server's worker thread, and a retired lane is decoded on
  one decode thread. All three enqueue on the device's current (default)
  stream, so the card runs their work in the order it was enqueued and the
  host work of the three overlaps; a latent handed from one thread to
  another needs no event or ``record_stream``. Grad mode is per thread:
  the worker steps under ``torch.no_grad()`` (the pipeline's stages are
  ``no_grad`` methods), so nothing the server returns holds an autograd
  graph.
- **Noise.** ``sampling.get_noise(seed, 1, h, w, device)`` and, for an
  img2img lane, ``get_encode_noise`` (the offline pipeline's draws), so a
  lane equals the offline image for the same seed up to the batch shape.
- **Offload.** The transformer is acquired once per busy period through
  the pipeline's ``_resident("flux")`` seam and released when the server
  goes idle (per tick, ``Offloading.Full`` would copy it every step).
- **Refusals.** A pipeline with a mesh raises ``NotImplementedError``
  (dp/sp-sharded serving, ROADMAP Queue 1 item 6) after JAX's check that
  ``max_batch`` divides over dp; a streamed pipeline (``Offloading.Stream``,
  no resident transformer) raises ``ValueError``. A failed step fails its
  group's lanes and is never retried on another path.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .io.tokenizer import tokenize_and_pad
from .models.flux import compute_pe, flux_forward
from .pipelines.flux_pipeline import CLIP_MAX_LEN, T5_LEN_DEV, T5_LEN_SCHNELL
from .pipelines.sampling import (
    get_encode_noise,
    get_noise,
    latent_hw,
    make_img_ids,
    make_txt_ids,
    pack_latents,
)
from .util.device import resolve_device


class ServerBusy(RuntimeError):
    """Raised by ``FluxServer.submit`` when the request queue is at its
    ``max_queue`` bound; the HTTP front end maps it to 503."""


@dataclass
class _Lane:
    """One in-flight request."""

    future: Future
    prompt: str
    params: object
    latent: torch.Tensor           # [S_img, C] packed, f32
    txt: torch.Tensor              # [T, D]
    y: torch.Tensor                # [Dp]
    guidance: float
    sigmas: np.ndarray             # remaining schedule (>= 2 entries), f32
    step: int = 0
    t_submit: float = 0.0

    @property
    def done(self) -> bool:
        return self.step >= len(self.sigmas) - 1


@dataclass
class _Group:
    """Same-shape lanes that batch together."""

    h2: int
    w2: int
    txt_len: int
    lanes: List[_Lane] = field(default_factory=list)


class FluxServer:
    """Continuous-batching server over a loaded FluxPipeline.

    >>> server = FluxServer(pipe._inner, max_batch=4)
    >>> fut = server.submit("a cat", params)
    >>> image_array = fut.result()   # u8 [H, W, 3]
    >>> server.shutdown()
    """

    def __init__(self, pipeline, max_batch: int = 4, poll_ms: float = 2.0,
                 request_timeout_s: Optional[float] = None,
                 max_queue: Optional[int] = 256, encode_cache: int = 32):
        mesh = getattr(pipeline, "mesh", None)
        if mesh is not None:
            dp = mesh.shape.get("dp", 1)
            if max_batch % dp != 0:
                raise ValueError(f"max_batch ({max_batch}) must be a multiple of the mesh dp "
                                 f"axis ({dp}) for dp-sharded serving")
            raise NotImplementedError(
                "FluxServer on a pipeline with a mesh (dp/sp-sharded serving) is not ported "
                "to diffusion_rs_tpu_torch yet (ROADMAP Queue 1 item 6)")
        if getattr(pipeline, "streamed", None) is not None:
            raise ValueError("FluxServer needs the transformer resident or offloaded "
                             "(Offloading.Full); a streamed pipeline (Offloading.Stream) "
                             "has no batched step")
        self.pipe = pipeline
        self.device = resolve_device(pipeline.device)
        self.max_batch = max_batch
        self.poll_s = poll_ms / 1e3
        self.request_timeout_s = request_timeout_s
        # Backpressure: submits past this queue depth raise ServerBusy (HTTP
        # 503) instead of queueing without bound. None disables the bound.
        self.max_queue = max_queue
        # Prompt-encoding LRU: (prompt, t5_len) -> (txt [T, D], y [Dp]) on the
        # device. A hit skips the T5-XXL + CLIP forward (and under
        # Offloading.Full their copies to the device). 0 disables.
        self.encode_cache = encode_cache
        self._encode_lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        # Stampede guard: the first submitter of a new prompt registers an
        # in-flight Future under the lock; concurrent duplicates wait on it,
        # so a burst of N identical prompts pays one encode.
        self._encode_inflight: dict = {}
        self._queue: List[_Lane] = []
        self._active: List[_Lane] = []
        self._inflight = 0  # worker-maintained, read under _lock by stats()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # One decode thread: retiring lanes decode while the others step.
        self._decode_pool = ThreadPoolExecutor(max_workers=1,
                                               thread_name_prefix="drs-decode")
        # The transformer, held from the first tick of a busy period until
        # the server goes idle.
        self._flux_hold: Optional[contextlib.ExitStack] = None
        self._flux_p = None
        # metrics (guarded by _lock)
        self._m = {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "forwards": 0, "lane_steps": 0, "padded_lane_steps": 0,
            "encode_cache_hits": 0, "latency_sum_s": 0.0,
        }
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="drs-server")
        self._thread.start()

    # -- request intake --------------------------------------------------------

    def submit(self, prompt: str, params, init_image=None,
               strength: float = 0.6) -> Future:
        """Enqueue one prompt; the Future resolves to a u8 ``[H, W, 3]`` array.

        ``init_image`` makes the lane img2img: its schedule is truncated and
        its start latent interpolated with the VAE-encoded image, as
        ``FluxPipeline.img2img`` does; t2i and i2i lanes batch together."""
        # backpressure before any encode work
        if self.max_queue is not None:
            with self._lock:
                if len(self._queue) >= self.max_queue:
                    self._m["rejected"] += 1
                    raise ServerBusy(f"queue full ({len(self._queue)} >= {self.max_queue})")
        if init_image is not None and not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        p, dev = self.pipe, self.device
        t5_len = params.max_sequence_length or (
            T5_LEN_DEV if p.flux_cfg.guidance_embeds else T5_LEN_SCHNELL)
        txt0, y0 = self._encode_cached(prompt, t5_len)
        sigmas = p._sigmas(params)
        seed = params.seed if params.seed is not None else time.time_ns() % (1 << 31)
        noise = get_noise(seed, 1, params.height, params.width, dev)
        if init_image is not None:
            steps_run = max(1, min(int(round(params.num_steps * strength)), params.num_steps))
            sigmas = sigmas[params.num_steps - steps_run:]
            x = p._prepare_image_batch(init_image, 1, params)
            h, w = latent_hw(params.height, params.width)
            eps = get_encode_noise(seed, (1, h, w, p.vae_cfg.latent_channels), p.dtype, dev)
            lat = p._encode_image_any(x.to(dev), eps)
            sig0 = float(sigmas[0])
            noise = sig0 * noise + (1.0 - sig0) * lat.float()
        lane = _Lane(
            future=Future(), prompt=prompt, params=params,
            # the offline denoise's start: the noise in the model dtype, an f32 carry
            latent=pack_latents(noise.to(p.dtype)).float()[0],
            txt=txt0, y=y0, guidance=float(params.guidance_scale),
            sigmas=np.asarray(sigmas, np.float32), t_submit=time.perf_counter(),
        )
        with self._lock:
            self._queue.append(lane)
            self._m["submitted"] += 1
        return lane.future

    def _encode_cached(self, prompt: str, t5_len: int):
        """(txt [T, D], y [Dp]) of ``prompt``, from the LRU or encoded here."""
        ck = (prompt, t5_len)
        wait_fut = own_fut = None
        if self.encode_cache:
            with self._lock:
                cached = self._encode_lru.get(ck)
                if cached is not None:
                    self._encode_lru.move_to_end(ck)
                    self._m["encode_cache_hits"] += 1
                    return cached
                wait_fut = self._encode_inflight.get(ck)
                if wait_fut is None:
                    own_fut = self._encode_inflight[ck] = Future()
        if wait_fut is not None:
            # another submitter is encoding this prompt: its result (counted
            # as a hit, no encode ran here), or its exception
            out = wait_fut.result()
            with self._lock:
                self._m["encode_cache_hits"] += 1
            return out
        try:
            out = self._encode(prompt, t5_len)
        except BaseException as e:
            if own_fut is not None:
                with self._lock:
                    self._encode_inflight.pop(ck, None)
                own_fut.set_exception(e)
            raise
        if own_fut is not None:
            with self._lock:
                self._encode_lru[ck] = out
                while len(self._encode_lru) > self.encode_cache:
                    self._encode_lru.popitem(last=False)
                self._encode_inflight.pop(ck, None)
            own_fut.set_result(out)
        return out

    def _encode(self, prompt: str, t5_len: int):
        p, dev = self.pipe, self.device
        t5_ids = tokenize_and_pad([prompt], p.t5_tokenizer, pad_to=t5_len)
        clip_ids = tokenize_and_pad([prompt], p.clip_tokenizer)[:, :CLIP_MAX_LEN]
        txt, y = p._encode(torch.from_numpy(t5_ids).to(dev), torch.from_numpy(clip_ids).to(dev))
        return txt[0], y[0]

    def generate(self, prompts: List[str], params) -> List[np.ndarray]:
        futs = [self.submit(pr, params) for pr in prompts]
        return [f.result() for f in futs]

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=60)
        # in-flight decodes finish and resolve their futures before exit
        self._decode_pool.shutdown(wait=True)

    # -- metrics ---------------------------------------------------------------

    def stats(self) -> dict:
        """Snapshot of the serving counters (thread-safe)."""
        with self._lock:
            m = dict(self._m)
            m["queue_depth"] = len(self._queue)
            m["in_flight"] = self._inflight
        done = m["completed"]
        m["mean_latency_s"] = (m.pop("latency_sum_s") / done) if done else 0.0
        stepped = m["lane_steps"] + m["padded_lane_steps"]
        m["occupancy"] = (m["lane_steps"] / stepped) if stepped else 1.0
        return m

    # Monotonic stats are Prometheus counters (with the _total suffix that
    # rate() / increase() expect); point-in-time stats stay gauges.
    _COUNTERS = frozenset(
        {"submitted", "completed", "failed", "rejected", "forwards",
         "lane_steps", "padded_lane_steps", "encode_cache_hits"}
    )

    def metrics_text(self) -> str:
        """Prometheus text exposition of ``stats()`` (drs_server_*)."""
        lines = []
        for k, v in sorted(self.stats().items()):
            if k in self._COUNTERS:
                lines += [f"# TYPE drs_server_{k}_total counter", f"drs_server_{k}_total {v}"]
            else:
                lines += [f"# TYPE drs_server_{k} gauge", f"drs_server_{k} {v}"]
        return "\n".join(lines) + "\n"

    # -- batched step ----------------------------------------------------------

    def _cb_step(self, flux_params, latents, txts, ys, ts, dts, gs, pe):
        """One continuous-batched Euler step: per-lane t and dt (dt = 0 lanes
        are no-ops, the padding)."""
        p = self.pipe
        pred = flux_forward(flux_params, p.flux_cfg, latents.to(p.dtype), txts, ts, ys,
                            gs if p.flux_cfg.guidance_embeds else None, pe=pe)
        return latents + pred.float() * dts[:, None, None]

    # -- scheduler loop --------------------------------------------------------

    def _groups(self) -> List[_Group]:
        groups = {}
        for lane in self._active:
            h2 = (lane.params.height + 15) // 16
            w2 = (lane.params.width + 15) // 16
            key = (h2, w2, lane.txt.shape[0])
            if key not in groups:
                groups[key] = _Group(*key)
            groups[key].lanes.append(lane)
        return list(groups.values())

    def _acquire_flux(self):
        if self._flux_hold is None:
            hold = contextlib.ExitStack()
            self._flux_p = hold.enter_context(self.pipe._resident("flux"))
            self._flux_hold = hold
        return self._flux_p

    def _release_flux(self):
        if self._flux_hold is not None:
            self._flux_p = None
            self._flux_hold, hold = None, self._flux_hold
            hold.close()

    def _expire_stale(self):
        """Fail lanes (queued or in flight) past the per-request timeout."""
        if self.request_timeout_s is None:
            return
        now = time.perf_counter()
        expired = []
        with self._lock:
            keep_q = []
            for ln in self._queue:
                (expired if now - ln.t_submit > self.request_timeout_s else keep_q).append(ln)
            self._queue = keep_q
        keep_a = []
        for ln in self._active:
            (expired if now - ln.t_submit > self.request_timeout_s else keep_a).append(ln)
        self._active = keep_a
        with self._lock:
            self._inflight = len(self._active)
        for ln in expired:
            if not ln.future.done():
                ln.future.set_exception(TimeoutError(
                    f"request exceeded {self.request_timeout_s}s (prompt {ln.prompt!r})"))
        if expired:
            with self._lock:
                self._m["failed"] += len(expired)

    def _run(self):
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card, torch.no_grad():
            while not self._stop.is_set():
                with self._lock:
                    while self._queue and len(self._active) < self.max_batch:
                        self._active.append(self._queue.pop(0))
                    self._inflight = len(self._active)
                if not self._active:
                    # going idle: drop the transformer's device copy, so that
                    # Offloading.Full does not hold it between requests
                    self._release_flux()
                    time.sleep(self.poll_s)
                    continue
                self._expire_stale()
                if not self._active:
                    continue
                try:
                    self._tick()
                except Exception as e:
                    # A failure outside a group's step (those are contained in
                    # _tick) must not kill the worker, which would leave every
                    # Future waiting: fail the lanes in flight, keep serving.
                    for ln in self._active:
                        if not ln.future.done():
                            ln.future.set_exception(e)
                    with self._lock:
                        self._m["failed"] += len(self._active)
                    self._active = []
            self._release_flux()
        for ln in self._active + self._queue:
            if not ln.future.done():
                ln.future.cancel()

    def _tick(self):
        """One scheduler tick: step every shape group, retire finished lanes.
        A step that raises fails only its own group's lanes."""
        failed_lanes = []
        for group in self._groups():
            try:
                self._step_group(group)
            except Exception as e:
                for ln in group.lanes:
                    if not ln.future.done():
                        ln.future.set_exception(e)
                failed_lanes.extend(group.lanes)
        if failed_lanes:
            dead = set(map(id, failed_lanes))
            self._active = [ln for ln in self._active if id(ln) not in dead]
            with self._lock:
                self._m["failed"] += len(failed_lanes)
        # retire finished lanes on the decode thread: the lane frees at once
        # and the others keep stepping during the decode
        still = []
        for ln in self._active:
            if ln.done:
                self._decode_pool.submit(self._retire, ln)
            else:
                still.append(ln)
        self._active = still
        with self._lock:
            self._inflight = len(self._active)

    def _retire(self, ln: _Lane):
        """Decode one finished lane (on the decode thread)."""
        try:
            img = self.pipe._decode_any(ln.latent[None], ln.params.height, ln.params.width)
            arr = img[0].cpu().numpy()
            if not ln.future.cancelled():
                ln.future.set_result(arr)
            with self._lock:
                self._m["completed"] += 1
                self._m["latency_sum_s"] += time.perf_counter() - ln.t_submit
        except Exception as e:
            if not ln.future.done():
                ln.future.set_exception(e)
            with self._lock:
                self._m["failed"] += 1

    def _step_group(self, group: _Group):
        """One batched denoise step for one shape group."""
        lanes = group.lanes[: self.max_batch]
        b, dev = len(lanes), self.device
        latents = torch.stack([ln.latent for ln in lanes])
        txts = torch.stack([ln.txt for ln in lanes])
        ys = torch.stack([ln.y for ln in lanes])
        sig = np.array([ln.sigmas[ln.step:ln.step + 2] for ln in lanes], np.float32)
        ts = torch.from_numpy(sig[:, 0].copy()).to(dev)
        dts = torch.from_numpy(sig[:, 1] - sig[:, 0]).to(dev)  # f32 differences
        gs = torch.tensor([ln.guidance for ln in lanes], dtype=torch.float32, device=dev)
        # pad to the next power-of-two bucket with lane 0 at dt = 0
        bucket = 1
        while bucket < b:
            bucket *= 2
        bucket = min(bucket, self.max_batch)
        if b < bucket:
            padn = bucket - b

            def pad(t, fill=None):
                extra = t[:1].expand(padn, *t.shape[1:]) if fill is None else fill
                return torch.cat([t, extra])

            latents, txts, ys, ts, gs = (pad(t) for t in (latents, txts, ys, ts, gs))
            dts = pad(dts, torch.zeros(padn, dtype=torch.float32, device=dev))
        pe = compute_pe(self.pipe.flux_cfg, make_txt_ids(bucket, group.txt_len, dev),
                        make_img_ids(bucket, group.h2, group.w2, dev))
        out = self._cb_step(self._acquire_flux(), latents, txts, ys, ts, dts, gs, pe)
        for i, ln in enumerate(lanes):
            ln.latent = out[i]
            ln.step += 1
        with self._lock:
            self._m["forwards"] += 1
            self._m["lane_steps"] += b
            self._m["padded_lane_steps"] += bucket - b


def serve_http(server: FluxServer, host: str = "127.0.0.1", port: int = 8000,
               *, make_params=None, block: bool = True):
    """Minimal HTTP front end over a :class:`FluxServer`.

    Endpoints:
      * ``POST /generate``: JSON ``{"prompt": ..., "height": 1024, "width":
        1024, "num_steps": 28, "guidance_scale": 3.5, "seed": 7,
        "max_sequence_length": null, "init_image_b64": null, "strength":
        0.6}`` (all but ``prompt`` optional) -> ``image/png`` bytes
        (pipelines/api.encode_png). Concurrent requests batch into shared
        forwards. ``init_image_b64`` (an encoded image, decoded with Pillow)
        makes the lane img2img.
      * ``GET /metrics``: Prometheus text (``stats()``).
      * ``GET /healthz``: liveness.

    A missing ``prompt`` answers 400, a full queue (``ServerBusy``) 503 with
    ``Retry-After: 1``, any other failure 500. Standard library only
    (ThreadingHTTPServer): each connection thread waits on its lane's
    future. Returns the HTTPServer (call ``.shutdown()``) when
    ``block=False``."""
    import base64
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .pipelines.api import decode_image, encode_png
    from .pipelines.flux_pipeline import DiffusionGenerationParams

    def default_params(body: dict):
        return DiffusionGenerationParams(
            height=int(body.get("height", 1024)),
            width=int(body.get("width", 1024)),
            num_steps=int(body.get("num_steps", 28)),
            guidance_scale=float(body.get("guidance_scale", 3.5)),
            seed=body.get("seed"),
            max_sequence_length=body.get("max_sequence_length"),
        )

    params_fn = make_params or default_params

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, server.metrics_text().encode(), "text/plain; version=0.0.4")
            elif self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body["prompt"]
                init = None
                if body.get("init_image_b64"):
                    init = decode_image(base64.b64decode(body["init_image_b64"]))
                fut = server.submit(prompt, params_fn(body), init_image=init,
                                    strength=float(body.get("strength", 0.6)))
                self._send(200, encode_png(np.asarray(fut.result())), "image/png")
            except KeyError as e:
                self._send(400, f"missing field: {e}".encode(), "text/plain")
            except ServerBusy as e:
                self._send(503, str(e).encode(), "text/plain", [("Retry-After", "1")])
            except Exception as e:  # the connection answers; the server keeps serving
                self._send(500, str(e).encode(), "text/plain")

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return None
    threading.Thread(target=httpd.serve_forever, daemon=True, name="drs-http").start()
    return httpd
