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
latency, stage-time and step counters (Prometheus text, ``drs_server_*``).

What it records, always on (host clock, ``time.perf_counter``):

- **Per request** (``request_trace(future)``, the last ``REQUEST_RECORDS``
  requests): an id given when ``submit`` is entered, and the stamps
  ``arrive`` (submit entered, before any encode), ``queued`` (the encoded
  lane in the queue), ``admitted`` (taken from the queue by the worker),
  ``first_step`` / ``last_step`` (the host end of the enqueue of its first
  and last step), ``decode_start`` (on the decode thread) and ``done`` (as
  its Future resolves). ``mean_latency_s`` and the request timeout count
  from ``arrive``.
- **Per forward** (``trace_snapshot()``, the last ``TRACE_SPANS`` entries):
  a ``serve.forward`` entry with its host start and end, bucket, lane
  count, shape group and the lanes' request ids, and on a card a CUDA event
  recorded just after the Euler update, which ``trace_snapshot`` resolves to
  the host-clock time the device finished the forward; and one
  ``serve.idle`` entry per period in which the worker had no lane in flight.
  The forward and the decode also run inside ``trace_span`` for a profiler
  (``serve.forward``, ``serve.decode``); the submitter's encode is inside
  the pipeline's ``text-encode``.

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
- **Refusals.** ``max_batch`` must divide over the mesh's dp (JAX's
  check); a streamed pipeline (``Offloading.Stream``, no resident
  transformer) raises ``ValueError``. A failed step fails its group's lanes
  and is never retried on another path.

Under a mesh (a pipeline built with ``mesh=``: dp, sp, tp or any product)
the semantics are JAX's: buckets start at dp and double up to
``max_batch``, the lanes of a step split over dp, sp splits each lane's
image tokens inside ``flux_forward`` and tp runs the cut weights. The port
runs one process per rank, so:

- **Every rank builds the server** on its own copy of the pipeline, in the
  same order as the other ranks (the constructor makes a gloo group over
  the world for the command stream). Rank 0 is the leader: it owns the
  queue, the Futures, ``stats()`` / ``metrics_text()``, the prompt LRU and
  ``serve_http``; ``submit`` on another rank raises ``RuntimeError``.
  The others follow in a loop on their own worker thread, and their
  ``shutdown()`` returns when the leader's does.
- **One ordered command stream.** Every piece of work that issues
  collectives runs on the leader's worker thread, in one order: a lane's
  admission (its T5 + CLIP encode, which all-reduces under tp, and an
  img2img lane's VAE encode), each batched step, each retiring lane's
  decode. The leader broadcasts a small header per command (op, lane ids,
  the request's seed and generation params, the bucket) and every rank
  runs the same command. This gives up the single-process server's overlap
  of encode, step and decode threads, and only under a mesh: issued from
  three threads, collectives would reorder across ranks and deadlock.
- **Ids and scalars, not activations.** Each rank keeps its own lane
  states (text states, latents), keyed by lane id and made by the same
  commands; noise is drawn on every rank from the lane's seed
  (``sampling.get_noise``), the prompt LRU is mirrored by running the same
  lookups in the same order. A step's output is gathered over sp and dp, so
  that every rank holds every lane's whole latent; the leader decodes (the
  VAE is whole on every rank) and resolves the Future. Only an img2img
  lane's encoded init latent, which the other ranks cannot make, is
  broadcast.
- **No hangs.** A command runs in stages (the local preparation, then the
  work with collectives); after each, every rank agrees on the outcome
  (one small all-gather), so a stage that fails on any rank fails the
  command's lanes on every rank, the leader's Futures with the failing
  rank's message, and the server goes on. (A rank that fails between two
  collectives of one forward, while the others wait in the second, is not
  contained.) While idle the leader sends a no-op every few seconds, so
  that a follower's wait never reaches the process group's timeout; its
  ``shutdown()`` sends the stop command.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .io.tokenizer import tokenize_and_pad
from .models.flux import compute_pe, flux_forward
from .parallel.mesh import batch_sharding, sequence_sharding
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
from .util.tracing import SpanLog, trace_span

# seconds of leader idleness between no-op commands under a mesh
HEARTBEAT_S = 5.0
# requests whose records request_trace keeps (the oldest go first)
REQUEST_RECORDS = 4096
# forward and idle entries that trace_snapshot keeps (the oldest go first)
TRACE_SPANS = 4096


class ServerBusy(RuntimeError):
    """Raised by ``FluxServer.submit`` when the request queue is at its
    ``max_queue`` bound; the HTTP front end maps it to 503."""


@dataclass
class RequestTrace:
    """One request's stamps on the host clock (``time.perf_counter``); a
    stage not reached is None. Under a mesh the leader encodes in the admit
    command, after ``admitted``, so there ``queued`` equals ``arrive``."""

    id: int
    arrive: float                        # submit entered, before any encode
    queued: Optional[float] = None       # in the queue
    admitted: Optional[float] = None     # taken from the queue by the worker
    first_step: Optional[float] = None   # host end of its first step's enqueue
    last_step: Optional[float] = None    # host end of its last step's enqueue
    decode_start: Optional[float] = None
    done: Optional[float] = None         # as its Future resolves


@dataclass
class _Lane:
    """One in-flight request (under a mesh every rank holds one per lane;
    only the leader's carries the Future)."""

    future: Optional[Future]
    prompt: str
    params: object
    latent: torch.Tensor           # [S_img, C] packed, f32
    txt: torch.Tensor              # [T, D]
    y: torch.Tensor                # [Dp]
    guidance: float
    sigmas: np.ndarray             # remaining schedule (>= 2 entries), f32
    step: int = 0
    lane_id: int = -1
    rec: Optional[RequestTrace] = None  # the leader's

    @property
    def done(self) -> bool:
        return self.step >= len(self.sigmas) - 1


@dataclass
class _Request:
    """A request waiting in the leader's queue under a mesh (encoded when a
    lane frees, inside the command stream)."""

    future: Future
    prompt: str
    params: object
    init_image: object
    strength: float
    t5_len: int
    seed: int
    rec: Optional[RequestTrace] = None


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
        # dp-sharded serving: batches are laid out over the pipeline's mesh
        self._mesh = getattr(pipeline, "mesh", None)
        self._dp = 1 if self._mesh is None else self._mesh.shape.get("dp", 1)
        if max_batch % self._dp != 0:
            raise ValueError(f"max_batch ({max_batch}) must be a multiple of the mesh dp "
                             f"axis ({self._dp}) for dp-sharded serving")
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
            # stage sums over completed requests (their RequestTrace)
            "queue_wait_seconds": 0.0, "encode_seconds": 0.0, "decode_seconds": 0.0,
        }
        # request records by id(Future), with a weak reference to it (a
        # record does not keep a Future and its image alive); the forward
        # and idle log
        self._records: "OrderedDict[int, tuple]" = OrderedDict()
        self._request_ids = itertools.count()
        self._spans = SpanLog(TRACE_SPANS)
        # under a mesh: the command stream's group, every rank's lane states
        # by id, and whether this rank leads
        self._cmd_group = None
        self.leader = True
        if self._mesh is not None and dist.is_initialized() and dist.get_world_size() > 1:
            self._cmd_group = dist.new_group(backend="gloo")  # collective: every rank
            self.leader = dist.get_rank() == 0
        self._lanes: Dict[int, _Lane] = {}
        self._lane_ids = itertools.count()
        run = self._run if self._mesh is None else self._lead if self.leader else self._follow
        self._thread = threading.Thread(target=run, daemon=True, name="drs-server")
        self._thread.start()

    # -- request intake --------------------------------------------------------

    def submit(self, prompt: str, params, init_image=None,
               strength: float = 0.6) -> Future:
        """Enqueue one prompt; the Future resolves to a u8 ``[H, W, 3]`` array.

        ``init_image`` makes the lane img2img: its schedule is truncated and
        its start latent interpolated with the VAE-encoded image, as
        ``FluxPipeline.img2img`` does; t2i and i2i lanes batch together.
        Under a mesh only the leader (rank 0) takes requests, and the lane
        is encoded when it is admitted (in the command stream)."""
        arrive = time.perf_counter()
        if not self.leader:
            raise RuntimeError(f"FluxServer under a mesh takes requests on rank 0 only "
                               f"(this is rank {dist.get_rank()})")
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
        seed = params.seed if params.seed is not None else time.time_ns() % (1 << 31)
        if self._mesh is not None:
            req = _Request(future=Future(), prompt=prompt, params=params,
                           init_image=init_image, strength=strength, t5_len=t5_len,
                           seed=seed)
            req.rec = self._track(req.future, arrive)
            req.rec.queued = arrive
            with self._lock:
                self._queue.append(req)
                self._m["submitted"] += 1
            return req.future
        txt0, y0 = self._encode_cached(prompt, t5_len)
        sigmas = p._sigmas(params)
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
            sigmas=np.asarray(sigmas, np.float32),
        )
        lane.rec = self._track(lane.future, arrive)
        with self._lock:
            lane.rec.queued = time.perf_counter()
            self._queue.append(lane)
            self._m["submitted"] += 1
        return lane.future

    def _track(self, fut: Future, arrive: float) -> RequestTrace:
        """A new request's record, kept for :meth:`request_trace`."""
        rec = RequestTrace(id=next(self._request_ids), arrive=arrive)
        with self._lock:
            self._records[id(fut)] = (weakref.ref(fut), rec)
            while len(self._records) > REQUEST_RECORDS:
                self._records.popitem(last=False)
        return rec

    def request_trace(self, fut: Future) -> Optional[dict]:
        """The record of the request whose Future is ``fut`` (a dict of
        :class:`RequestTrace`'s fields), or None where it is not kept."""
        with self._lock:
            ref, rec = self._records.get(id(fut), (None, None))
            if ref is None or ref() is not fut:
                return None
            return dataclasses.asdict(rec)

    def trace_snapshot(self) -> List[dict]:
        """The forward and idle log, oldest first (at most ``TRACE_SPANS``
        entries): dicts of name, thread, start and end (host clock) and the
        entry's attrs. A ``serve.forward``'s ``device_end`` is the host-clock
        time at which the device finished its Euler update: an anchor event
        is recorded and synchronised, the host clock read, and each
        forward's event placed ``elapsed_time`` before it (None off a
        card)."""
        spans = self._spans.snapshot()
        anchor = t_anchor = None
        if any("event" in sp.attrs for sp in spans):
            with torch.cuda.device(self.device):
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record()
                torch.cuda.synchronize(self.device)
            t_anchor = time.perf_counter()
        out = []
        for sp in spans:
            attrs = dict(sp.attrs)
            ev = attrs.pop("event", None)
            entry = {"name": sp.name, "thread": sp.thread, "start": sp.start, "end": sp.end,
                     **attrs}
            if sp.name == "serve.forward":
                entry["device_end"] = (None if ev is None
                                       else t_anchor - ev.elapsed_time(anchor) * 1e-3)
            out.append(entry)
        return out

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
        return self._encode_ids(*self._token_ids(prompt, t5_len))

    def _token_ids(self, prompt: str, t5_len: int):
        p = self.pipe
        t5_ids = tokenize_and_pad([prompt], p.t5_tokenizer, pad_to=t5_len)
        clip_ids = tokenize_and_pad([prompt], p.clip_tokenizer)[:, :CLIP_MAX_LEN]
        return t5_ids, clip_ids

    def _encode_ids(self, t5_ids, clip_ids):
        dev = self.device
        txt, y = self.pipe._encode(torch.from_numpy(t5_ids).to(dev),
                                   torch.from_numpy(clip_ids).to(dev))
        return txt[0], y[0]

    def generate(self, prompts: List[str], params) -> List[np.ndarray]:
        futs = [self.submit(pr, params) for pr in prompts]
        return [f.result() for f in futs]

    def shutdown(self):
        """Stop serving. Under a mesh the leader's sends the stop command and
        a follower's returns once it has come."""
        self._stop.set()
        self._thread.join(timeout=60 if self.leader else None)
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
         "lane_steps", "padded_lane_steps", "encode_cache_hits",
         "queue_wait_seconds", "encode_seconds", "decode_seconds"}
    )

    def metrics_text(self) -> str:
        """Prometheus text exposition of ``stats()`` (drs_server_*). The stage
        sums over completed requests: ``queue_wait_seconds`` (queued to
        admitted), ``encode_seconds`` (arrival to queued: tokenize, the
        T5 + CLIP encode, the LRU wait), ``decode_seconds`` (its last step
        enqueued to its image: the device finishing the lane, the decode
        thread's queue, the decode and the copy to the host)."""
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
        are no-ops, the padding). Under a mesh the inputs are this rank's
        rows."""
        p = self.pipe
        pred = flux_forward(flux_params, p.flux_cfg, latents.to(p.dtype), txts, ts, ys,
                            gs if p.flux_cfg.guidance_embeds else None, pe=pe, mesh=p.mesh)
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
                (expired if now - ln.rec.arrive > self.request_timeout_s else keep_q).append(ln)
            self._queue = keep_q
        keep_a, gone = [], []
        for ln in self._active:
            (gone if now - ln.rec.arrive > self.request_timeout_s else keep_a).append(ln)
        self._active = keep_a
        if gone and self._mesh is not None:
            self._command({"op": "drop", "ids": [ln.lane_id for ln in gone]})
        expired += gone
        with self._lock:
            self._inflight = len(self._active)
        for ln in expired:
            if not ln.future.done():
                ln.future.set_exception(TimeoutError(
                    f"request exceeded {self.request_timeout_s}s (prompt {ln.prompt!r})"))
        if expired:
            with self._lock:
                self._m["failed"] += len(expired)

    def _on_card(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _run(self):
        idle_since = None
        with self._on_card(), torch.no_grad():
            while not self._stop.is_set():
                with self._lock:
                    while self._queue and len(self._active) < self.max_batch:
                        ln = self._queue.pop(0)
                        ln.rec.admitted = time.perf_counter()
                        self._active.append(ln)
                    self._inflight = len(self._active)
                idle_since = self._mark_idle(idle_since)
                if not self._active:
                    # going idle: drop the transformer's device copy, so that
                    # Offloading.Full does not hold it between requests
                    self._release_flux()
                    time.sleep(self.poll_s)
                    continue
                self._serve_active()
            self._release_flux()
        self._mark_idle(idle_since, stopping=True)
        for ln in self._active + self._queue:
            if not ln.future.done():
                ln.future.cancel()

    def _mark_idle(self, since: Optional[float], stopping: bool = False) -> Optional[float]:
        """The start of the worker's idle period in progress (no lane in
        flight), or None while it has lanes; a period that ends (or is open
        at ``stopping``) goes to the log as one ``serve.idle`` entry."""
        if not self._active and not stopping:
            return time.perf_counter() if since is None else since
        if since is not None:
            self._spans.add("serve.idle", since, time.perf_counter())
        return None

    def _serve_active(self):
        """Expire, then one tick over the lanes in flight."""
        self._expire_stale()
        if not self._active:
            return
        try:
            self._tick()
        except Exception as e:
            # A failure outside a group's step (those are contained in
            # _tick) must not kill the worker, which would leave every
            # Future waiting: fail the lanes in flight, keep serving.
            failed, self._active = self._active, []
            for ln in failed:
                if not ln.future.done():
                    ln.future.set_exception(e)
            with self._lock:
                self._m["failed"] += len(failed)
            if self._mesh is not None:
                self._command({"op": "drop", "ids": [ln.lane_id for ln in failed]})

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
        done = [ln for ln in self._active if ln.done]
        self._active = [ln for ln in self._active if not ln.done]
        with self._lock:
            self._inflight = len(self._active)
        if self._mesh is None:
            # retire finished lanes on the decode thread: the lane frees at
            # once and the others keep stepping during the decode
            for ln in done:
                self._decode_pool.submit(self._retire, ln)
        elif done:
            self._command({"op": "retire", "ids": [ln.lane_id for ln in done]})
            for ln in done:
                self._retire(ln)

    def _retire(self, ln: _Lane):
        """Decode one finished lane (on the decode thread; under a mesh on
        the leader's worker)."""
        rec = ln.rec
        rec.decode_start = time.perf_counter()
        try:
            with trace_span("serve.decode"):
                img = self.pipe._decode_any(ln.latent[None], ln.params.height, ln.params.width)
                arr = img[0].cpu().numpy()
            rec.done = time.perf_counter()
            if not ln.future.cancelled():
                ln.future.set_result(arr)
            with self._lock:
                self._m["completed"] += 1
                self._m["latency_sum_s"] += rec.done - rec.arrive
                self._m["queue_wait_seconds"] += rec.admitted - rec.queued
                self._m["encode_seconds"] += rec.queued - rec.arrive
                self._m["decode_seconds"] += rec.done - rec.last_step
        except Exception as e:
            if not ln.future.done():
                ln.future.set_exception(e)
            with self._lock:
                self._m["failed"] += 1

    def _batch(self, lanes: List[_Lane], bucket: int):
        """The lanes' step inputs, padded to ``bucket`` with lane 0 at dt = 0:
        (latents, txts, ys, ts, dts, gs)."""
        dev = self.device
        latents = torch.stack([ln.latent for ln in lanes])
        txts = torch.stack([ln.txt for ln in lanes])
        ys = torch.stack([ln.y for ln in lanes])
        sig = np.array([ln.sigmas[ln.step:ln.step + 2] for ln in lanes], np.float32)
        ts = torch.from_numpy(sig[:, 0].copy()).to(dev)
        dts = torch.from_numpy(sig[:, 1] - sig[:, 0]).to(dev)  # f32 differences
        gs = torch.tensor([ln.guidance for ln in lanes], dtype=torch.float32, device=dev)
        if len(lanes) < bucket:
            padn = bucket - len(lanes)

            def pad(t, fill=None):
                extra = t[:1].expand(padn, *t.shape[1:]) if fill is None else fill
                return torch.cat([t, extra])

            latents, txts, ys, ts, gs = (pad(t) for t in (latents, txts, ys, ts, gs))
            dts = pad(dts, torch.zeros(padn, dtype=torch.float32, device=dev))
        return latents, txts, ys, ts, dts, gs

    def _step_group(self, group: _Group):
        """One batched denoise step for one shape group: the lanes padded to
        the next power-of-two bucket (times dp) with lane 0 at dt = 0."""
        lanes = group.lanes[: self.max_batch]
        b = len(lanes)
        bucket = self._dp
        while bucket < b:
            bucket *= 2
        bucket = min(bucket, self.max_batch)
        attrs = {"bucket": bucket, "lanes": b, "group": (group.h2, group.w2, group.txt_len),
                 "ids": [ln.rec.id for ln in lanes]}
        with trace_span("serve.forward", self._spans, attrs) as span:
            if self._mesh is not None:
                self._command({"op": "step", "ids": [ln.lane_id for ln in lanes],
                               "bucket": bucket})
            else:
                dev = self.device
                pe = compute_pe(self.pipe.flux_cfg, make_txt_ids(bucket, group.txt_len, dev),
                                make_img_ids(bucket, group.h2, group.w2, dev))
                out = self._cb_step(self._acquire_flux(), *self._batch(lanes, bucket), pe)
                for i, ln in enumerate(lanes):
                    ln.latent = out[i]
                    ln.step += 1
            if self.device.type == "cuda":
                span.attrs["event"] = torch.cuda.Event(enable_timing=True)
                span.attrs["event"].record()
            enqueued = time.perf_counter()
        for ln in lanes:
            if ln.rec.first_step is None:
                ln.rec.first_step = enqueued
            ln.rec.last_step = enqueued
        with self._lock:
            self._m["forwards"] += 1
            self._m["lane_steps"] += b
            self._m["padded_lane_steps"] += bucket - b

    # -- under a mesh: the leader, the followers and the command stream -------

    def _lead(self):
        """The leader's worker: admits queued requests (each an admit
        command), ticks, and ends with the stop command."""
        last = time.perf_counter()
        idle_since = None
        with self._on_card(), torch.no_grad():
            while not self._stop.is_set():
                with self._lock:
                    admit = []
                    while self._queue and len(self._active) + len(admit) < self.max_batch:
                        req = self._queue.pop(0)
                        req.rec.admitted = time.perf_counter()
                        admit.append(req)
                for req in admit:
                    lane = self._admit(req)
                    if lane is not None:
                        self._active.append(lane)
                with self._lock:
                    self._inflight = len(self._active)
                idle_since = self._mark_idle(idle_since)
                if self._active:
                    self._serve_active()
                    last = time.perf_counter()
                    continue
                self._release_flux()
                if time.perf_counter() - last > HEARTBEAT_S:
                    self._command({"op": "noop"})
                    last = time.perf_counter()
                time.sleep(self.poll_s)
            self._release_flux()
            self._command({"op": "stop"})
        self._mark_idle(idle_since, stopping=True)
        for ln in self._active + self._queue:
            if not ln.future.done():
                ln.future.cancel()

    def _follow(self):
        """A follower's worker: runs the leader's commands in order until
        the stop command. A command that failed failed on every rank (the
        leader fails its Futures); its lanes are gone here too."""
        with self._on_card(), torch.no_grad():
            while True:
                cmd = self._broadcast(None)
                if cmd["op"] == "stop":
                    break
                try:
                    self._apply(cmd)
                except Exception:  # agreed on every rank; the leader reports it
                    pass
                if not self._lanes:
                    self._release_flux()
            self._release_flux()

    def _broadcast(self, cmd):
        """The leader's command header, on every rank."""
        if self._cmd_group is None:
            return cmd
        box = [cmd]
        dist.broadcast_object_list(box, src=0, group=self._cmd_group)
        return box[0]

    def _command(self, cmd: dict, req: Optional[_Request] = None):
        """Leader: send ``cmd`` and run it here (every rank runs it)."""
        return self._apply(self._broadcast(cmd), req)

    def _stage(self, fn) -> None:
        """Run ``fn`` on this rank, then agree with every rank on the
        outcome: raises on every rank when it failed on any, this rank's own
        exception where it failed here, else the failing rank's message."""
        err = None
        try:
            fn()
        except Exception as e:
            err = e
        msg = None if err is None else f"{type(err).__name__}: {err}"
        msgs = [msg]
        if self._cmd_group is not None:
            msgs = [None] * dist.get_world_size()
            dist.all_gather_object(msgs, msg, group=self._cmd_group)
        if err is not None:
            raise err
        for r, m in enumerate(msgs):
            if m is not None:
                raise RuntimeError(f"rank {r} failed: {m}")

    def _apply(self, cmd: dict, req: Optional[_Request] = None):
        op = cmd["op"]
        if op == "admit":
            return self._apply_admit(cmd, req)
        if op == "step":
            try:
                self._apply_step(cmd)
            except Exception:
                for i in cmd["ids"]:
                    self._lanes.pop(i, None)
                raise
        elif op in ("retire", "drop"):
            for i in cmd["ids"]:
                self._lanes.pop(i, None)
        return None

    def _admit(self, req: _Request) -> Optional[_Lane]:
        """Leader: admit one request as a lane (an admit command); on failure
        its Future fails and None is returned."""
        cmd = {"op": "admit", "id": next(self._lane_ids), "prompt": req.prompt,
               "t5_len": req.t5_len, "seed": req.seed, "params": req.params,
               "img2img": req.init_image is not None, "strength": req.strength}
        try:
            return self._command(cmd, req)
        except Exception as e:
            if not req.future.done():
                req.future.set_exception(e)
            with self._lock:
                self._m["failed"] += 1
            return None

    def _apply_admit(self, cmd: dict, req: Optional[_Request]) -> _Lane:
        """Every rank: the lane's state. Stage 1 (local): the prompt's token
        ids unless the mirrored LRU holds its encoding, the schedule, the
        noise from the seed, and on the leader an img2img lane's VAE encode.
        Stage 2: the text encode (T5 all-reduces under tp) and the init
        latent's broadcast."""
        p, dev = self.pipe, self.device
        params = cmd["params"]
        key = (cmd["prompt"], cmd["t5_len"])
        st = {"enc": self._encode_lru.get(key) if self.encode_cache else None}

        def prepare():
            if st["enc"] is None:
                st["ids"] = self._token_ids(*key)
            sigmas = p._sigmas(params)
            if cmd["img2img"]:
                n = params.num_steps
                steps_run = max(1, min(int(round(n * cmd["strength"])), n))
                sigmas = sigmas[n - steps_run:]
                if req is not None:
                    x = p._prepare_image_batch(req.init_image, 1, params)
                    h, w = latent_hw(params.height, params.width)
                    eps = get_encode_noise(cmd["seed"], (1, h, w, p.vae_cfg.latent_channels),
                                           p.dtype, dev)
                    st["lat"] = p._encode_image_any(x.to(dev), eps).float()
            st["sigmas"] = np.asarray(sigmas, np.float32)
            st["noise"] = get_noise(cmd["seed"], 1, params.height, params.width, dev)

        def encode():
            if st["enc"] is None:
                st["enc"] = self._encode_ids(*st["ids"])
                if self.encode_cache:
                    self._encode_lru[key] = st["enc"]
                    while len(self._encode_lru) > self.encode_cache:
                        self._encode_lru.popitem(last=False)
            elif self.encode_cache:
                self._encode_lru.move_to_end(key)
                with self._lock:
                    self._m["encode_cache_hits"] += 1
            if cmd["img2img"]:
                st["lat"] = self._broadcast_latent(st.get("lat"), params)

        self._stage(prepare)
        try:
            self._stage(encode)
        except Exception:
            self._encode_lru.pop(key, None)  # the mirrored LRUs stay equal
            raise
        noise = st["noise"]
        if cmd["img2img"]:
            sig0 = float(st["sigmas"][0])
            noise = sig0 * noise + (1.0 - sig0) * st["lat"]
        txt, y = st["enc"]
        lane = _Lane(future=None if req is None else req.future, prompt=cmd["prompt"],
                     params=params, latent=pack_latents(noise.to(p.dtype)).float()[0],
                     txt=txt, y=y, guidance=float(params.guidance_scale), sigmas=st["sigmas"],
                     lane_id=cmd["id"], rec=None if req is None else req.rec)
        self._lanes[cmd["id"]] = lane
        return lane

    def _broadcast_latent(self, lat: Optional[torch.Tensor], params) -> torch.Tensor:
        """The leader's encoded init latent [1, C, h, w] f32 on every rank."""
        if self._cmd_group is None:
            return lat
        h, w = latent_hw(params.height, params.width)
        host = (lat.cpu() if lat is not None else
                torch.empty((1, self.pipe.vae_cfg.latent_channels, h, w), dtype=torch.float32))
        dist.broadcast(host, src=0, group=self._cmd_group)
        return host.to(self.device)

    def _apply_step(self, cmd: dict) -> None:
        """Every rank: one batched step of the command's lanes. This rank
        takes its dp rows of the bucket and its sp rows of their image
        tokens, steps them, and gathers the whole bucket's latents back."""
        lanes = [self._lanes[i] for i in cmd["ids"]]
        bucket, mesh, out = cmd["bucket"], self._mesh, []

        def run():
            latents, txts, ys, ts, dts, gs = self._batch(lanes, bucket)
            rows, seq = batch_sharding(mesh), sequence_sharding(mesh)
            local = seq.local(latents)
            txts, ys, ts, dts, gs = (rows.local(t) for t in (txts, ys, ts, dts, gs))
            h2 = (lanes[0].params.height + 15) // 16
            w2 = (lanes[0].params.width + 15) // 16
            bl = txts.shape[0]
            pe = compute_pe(self.pipe.flux_cfg, make_txt_ids(bl, txts.shape[1], self.device),
                            make_img_ids(bl, h2, w2, self.device))
            step = self._cb_step(self._acquire_flux(), local, txts, ys, ts, dts, gs, pe)
            out.append(seq.gather(step, latents.shape))

        self._stage(run)
        for i, ln in enumerate(lanes):
            ln.latent = out[0][i]
            ln.step += 1


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
