"""Per-block weight streaming for FLUX (port of ``models/flux_streaming.py``).

``Offloading.Stream``: the transformer's blocks stay in host memory and
stream to the device one block at a time, overlapped with compute; the
embedders and the final layer stay resident.

* **Packed blocks.** Each block's leaves are written once, at load, into a
  slice of its own of one u8 host buffer for the double blocks and one for
  the single blocks (page-locked at their exact size for a CUDA device),
  each leaf at a 128-byte offset, straight from wherever the params are
  (host or card), block by block (util/hostmem.py). Streaming a block is
  one host-to-device copy; on the device the block is rebuilt as views of
  its slot, with no copy.
* **A ring of device slots.** ``lookahead + 1`` slots of the largest
  block's size, allocated once. Copies run on their own CUDA stream. Each
  slot has a *copied* event, which the compute stream waits on before the
  block runs, and a *consumed* event, recorded on the compute stream after
  the block, which the copy stream waits on before it overwrites the slot.
  The fixed ring bounds device memory and makes reuse explicit: a buffer
  per block handed back to the caching allocator could be given to the
  next copy while a block still reads it.
* **Lookahead.** DIFFUSION_RS_TPU_STREAM_LOOKAHEAD (default 2, read every
  step) blocks are in flight ahead of the one computing.

The prediction is models/flux.flux_forward with the blocks taken from the
stream, and the Euler update is pipelines/sampling.denoise's (f32 carry,
``pred.float() * float(t_prev - t_curr)``), so a streamed latent equals the
resident one bit for bit. On a CPU device the blocks are views of the host
buffers.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from ..util.device import resolve_device
from ..util.hostmem import host_buffer, meta_template, pack_into, tree_layout, unpack_tree
from ..util.tree import take_layer, tree_map
from .flux import FluxConfig, flux_forward

_PRE = ("img_in", "txt_in", "time_in", "vector_in", "guidance_in")


def _lookahead() -> int:
    return max(1, int(os.environ.get("DIFFUSION_RS_TPU_STREAM_LOOKAHEAD", "2")))


def _pack_blocks(kind: str, blocks, n: int, pin: bool):
    """``n`` blocks packed one at a time into one host buffer (pinned with
    ``pin``), each block in a slice of its own. Returns the slices and the
    blocks' (template, specs), which every block must share."""
    blocks = iter(blocks)
    first = next(blocks, None)
    if first is None:
        if n:
            raise ValueError(f"no {kind} blocks for the config's {n}")
        return [], (None, ())
    specs, nbytes = tree_layout(first)
    arena = host_buffer(n * nbytes, pin)
    bufs = []
    for i, tree in enumerate(itertools.chain([first], blocks)):
        if i and tree_layout(tree)[0] != specs:
            raise ValueError(f"{kind} block {i}'s leaves differ from block 0's")
        if i == n:
            raise ValueError(f"more {kind} blocks than the config's {n}")
        bufs.append(arena[i * nbytes:(i + 1) * nbytes])
        pack_into(bufs[-1], tree, specs)
    if len(bufs) != n:
        raise ValueError(f"{len(bufs)} {kind} blocks for the config's {n}")
    return bufs, (meta_template(first), specs)


class _Ring:
    """``n`` device slots of ``nbytes`` with their copied / consumed events."""

    def __init__(self, n: int, nbytes: int, device: torch.device):
        self.slots = [torch.empty(nbytes, dtype=torch.uint8, device=device) for _ in range(n)]
        self.copied = [torch.cuda.Event() for _ in range(n)]
        self.consumed = [torch.cuda.Event() for _ in range(n)]


class StreamedFlux:
    """FLUX params with the blocks packed in host memory, run with
    per-block host-to-device streaming (``device`` defaults to CUDA and
    raises without it; on ``"cpu"`` the blocks run from the host buffers)."""

    def __init__(self, params, cfg: FluxConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._setup({k: params[k] for k in _PRE if k in params}, params["final"],
                    (take_layer(params["double"], i) for i in range(cfg.num_layers)),
                    (take_layer(params["single"], i) for i in range(cfg.num_single_layers)))

    @classmethod
    def from_block_trees(cls, pre, final, doubles, singles, cfg: FluxConfig, device="cuda"):
        """From per-block trees (iterables of the double and the single
        blocks' params), packed one at a time."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._setup(pre, final, doubles, singles)
        return self

    def _setup(self, pre, final, doubles, singles):
        self.pre_dev = tree_map(lambda t: t.to(self.device), pre)
        self.final_dev = tree_map(lambda t: t.to(self.device), final)
        self._pack(doubles, singles)
        self._ring = None
        self._copy = None

    def _pack(self, doubles, singles):
        pin = self.device.type == "cuda"
        self.dbl_bufs, self.dbl_meta = _pack_blocks("double", doubles, self.cfg.num_layers, pin)
        self.sgl_bufs, self.sgl_meta = _pack_blocks("single", singles,
                                                    self.cfg.num_single_layers, pin)
        self._blocks = ([(b, self.dbl_meta) for b in self.dbl_bufs]
                        + [(b, self.sgl_meta) for b in self.sgl_bufs])
        self.bytes_per_step = sum(b.numel() for b, _ in self._blocks)

    # -- the stream -----------------------------------------------------------

    def _ring_for(self, n: int) -> _Ring:
        if self._copy is None:
            self._copy = torch.cuda.Stream(device=self.device)
        if self._ring is None or len(self._ring.slots) != n:
            # the old ring's slots go back to the allocator only after every
            # copy into them
            torch.cuda.current_stream(self.device).wait_stream(self._copy)
            self._ring = _Ring(n, max(b.numel() for b, _ in self._blocks), self.device)
        return self._ring

    def _stream(self):
        """The blocks of one forward, in order, each as views of its device
        slot once its copy has landed (the compute stream waits on the
        slot's copied event). Asking for block j + 1 records block j's
        consumed event and issues the copy that reuses its slot."""
        if self.device.type != "cuda":
            for buf, meta in self._blocks:
                yield unpack_tree(buf, *meta)
            return
        ring = self._ring_for(_lookahead() + 1)
        n_slots, n = len(ring.slots), len(self._blocks)
        compute = torch.cuda.current_stream(self.device)
        issued = 0

        def issue():
            nonlocal issued
            s, buf = issued % n_slots, self._blocks[issued][0]
            with torch.cuda.stream(self._copy):
                self._copy.wait_event(ring.consumed[s])
                ring.slots[s][:buf.numel()].copy_(buf, non_blocking=True)
                ring.copied[s].record(self._copy)
            issued += 1

        while issued < min(n, n_slots):
            issue()
        for j in range(n):
            s = j % n_slots
            compute.wait_event(ring.copied[s])
            yield unpack_tree(ring.slots[s], *self._blocks[j][1])
            ring.consumed[s].record(compute)
            if issued < n:
                issue()

    def _forward(self, img, txt, t_vec, y, guidance, pe, blocks):
        params = {**self.pre_dev, "final": self.final_dev}
        pred = flux_forward(params, self.cfg, img, txt, t_vec, y, guidance, pe=pe, blocks=blocks)
        if next(blocks, None) is not None:  # retires the last block
            raise ValueError("the packed blocks outnumber the config's layers")
        return pred

    # -- the step -------------------------------------------------------------

    def predict(self, img, txt, t: float, y, guidance, pe) -> torch.Tensor:
        """The transformer's prediction for packed latents ``img`` (in the
        activation dtype) at time ``t``, the blocks streamed."""
        t_vec = torch.full((img.shape[0],), t, dtype=torch.float32, device=img.device)
        return self._forward(img, txt, t_vec, y, guidance, pe, self._stream())

    def step(self, img, txt, t_curr, t_prev, y, guidance, pe) -> torch.Tensor:
        """One Euler step of the f32 packed latents ``img`` [B, S, C]."""
        tc, tp = np.float32(t_curr), np.float32(t_prev)
        pred = self.predict(img.to(txt.dtype), txt, float(tc), y, guidance, pe)
        return img + pred.float() * float(tp - tc)

    def denoise(self, img0, txt, y, guidance, pe, sigmas) -> torch.Tensor:
        """The whole Euler loop over ``sigmas``, one streamed pass per step."""
        img = img0.float()
        sig = np.asarray(sigmas, np.float32)
        for t_curr, t_prev in zip(sig[:-1], sig[1:]):
            img = self.step(img, txt, t_curr, t_prev, y, guidance, pe)
        return img

    # -- measurement ------------------------------------------------------------

    def _seconds(self, fn, iters: int) -> float:
        """Mean seconds of ``fn`` over ``iters`` calls after one warm-up:
        CUDA events on the current stream, or the host clock on a CPU."""
        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters

    def overlap_report(self, img, txt, y, guidance, pe, iters: int = 3) -> dict:
        """Whether streaming overlaps the copies with compute:

        * ``h2d_gbps``: host-to-device GiB/s of six real double-block copies
          in a row; ``h2d_s``: a step's bytes at that rate;
        * ``compute_s``: a step's prediction with every block resident (the
          first double and single block's buffers on the device, reused);
        * ``stream_s``: the real streamed step;
        * ``overlap_efficiency``: ``max(compute_s, h2d_s) / stream_s`` (1 is
          perfect overlap); ``bytes_per_step_gb`` in GiB.

        Timed with CUDA events (the host clock on a CPU), unrounded."""
        cfg, dev, dt = self.cfg, self.device, txt.dtype
        sample = (self.dbl_bufs * 6)[:6]
        dst = torch.empty(max(b.numel() for b in sample), dtype=torch.uint8, device=dev)

        def copies():
            for b in sample:
                dst[:b.numel()].copy_(b, non_blocking=True)

        h2d_gbps = sum(b.numel() for b in sample) / self._seconds(copies, iters) / 2**30
        h2d_s = self.bytes_per_step / 2**30 / h2d_gbps

        dbl = unpack_tree(self.dbl_bufs[0].to(dev), *self.dbl_meta)
        sgl = unpack_tree(self.sgl_bufs[0].to(dev), *self.sgl_meta)
        x = img.to(dt)
        t_vec = torch.full((img.shape[0],), 0.7, dtype=torch.float32, device=img.device)

        def resident():
            blocks = itertools.chain(itertools.repeat(dbl, cfg.num_layers),
                                     itertools.repeat(sgl, cfg.num_single_layers))
            self._forward(x, txt, t_vec, y, guidance, pe, blocks)

        compute_s = self._seconds(resident, iters)
        stream_s = self._seconds(
            lambda: self.step(img.float(), txt, 0.7, 0.7 - 1 / 28, y, guidance, pe), iters)
        return {"h2d_gbps": h2d_gbps, "h2d_s": h2d_s, "compute_s": compute_s,
                "stream_s": stream_s,
                "overlap_efficiency": max(compute_s, h2d_s) / stream_s,
                "bytes_per_step_gb": self.bytes_per_step / 2**30}
