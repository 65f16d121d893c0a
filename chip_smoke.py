#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffusion_rs_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--steps N] [--full-depth]

Phases, each fatal on failure (non-zero exit, no final line; a line
``[t s] <phase> done`` marks the time since the start after each group):

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the host's memory (MemTotal, MemAvailable) and the PCIe
   link; build every CUDA kernel from ``diffusion_rs_tpu_torch/csrc``;
   the SASS line: per kernel function its instruction count and its
   HGMMA / IGMMA / HMMA / IMMA instructions (cuobjdump), failing unless
   every wgmma body (K1, K2, the bf16 and int8 flash bodies, the affine
   body) holds warpgroup MMAs (the int8 flash body IGMMA) and no kernel
   holds mma.sync;
2. hold each kernel against its plain PyTorch version on the card at its
   main-path shapes (error, kernel ms, plain ms, bound ms, library ms): K1
   and K8-s8 bit for bit (max-abs 0), K1 also timed per pass (quantize,
   product; profiler) beside torch._int_mm on its int8 operands, K2's
   decoded weight (the product with the identity) equal to dequantize's;
   the affine kernel (K4) also, untimed, for Q6_K, Q4_K and bnb int8; the
   seq-major flash kernels (K6, K7) at B1 H24 S4608 and the ragged S4112,
   K7 also against K6 on plain-rotated q/k (max-abs 0); the grouped kernel
   (K8: s8, Q8_0 and Q4_0) at the grouped double-block shapes (M 4096 +
   512), each group also against its own K1/K4 launch (max-abs 0); then
   the grad guard: a q8t linear and a flash call on inputs that require
   grad, under grad mode, must raise and launch nothing;
3. a tiny-config image on the card against the same image through the plain
   versions on the CPU (same weights, same noise): the default layout, and
   every stream fused and grouped (``fuse="img,txt,single,t5,grouped"``)
   with DIFFUSION_RS_TPU_FUSED_ROPE=1, under each of the ``inkernel`` and
   ``seqmajor`` attention layouts; and an img2img and an inpaint image
   through ``forward_arrays`` (same init image, noise and encoder sample);
4. the full-width FLUX.1-dev q8t path (19+38 blocks, hidden 3072) with
   T5-XXL nf4, CLIP-L bf16 and the VAE: one 1024x1024 image, batch 1,
   ``--steps`` denoise steps (default 4; the shapes are the 28-step run's),
   through ``FluxPipeline.forward_arrays`` on synthetic weights from a seed;
   the kernels' launch counters must match the path exactly;
5. one more 1-step image under torch.profiler: device time by kernel and
   the device's busy share; then the serve phase (4e) on the same
   pipeline: K1 at M 16384 / 2048 / 18432 and K3 at B4 S4608 against their
   plain versions, eight 1024x1024 ``--steps`` requests (two img2img lanes
   at 0.6 with phase 4's image, two prompts repeated) one by one through
   ``forward_arrays`` (the offline images, timed) and through
   ``serving.FluxServer(max_batch=4)`` in two bursts (after a warm-up
   forward of the 4-lane bucket; K1's launches tallied by M, K3's by B), each lane
   within the JAX server's band of its offline image, ``stats()``, exact
   launches per forward, served against one-by-one images/s and the peak
   memory beside the batch-4 capacity estimate; then, on the tiny config,
   one ``POST /generate`` and one ``GET /metrics`` through ``serve_http``
   on localhost and a 1-step img2img image under
   DIFFUSION_RS_TPU_TRACE_DIR whose trace must name the five spans and K1's
   kernel; then img2img and inpainting on the same
   pipeline, phase 4's image as the init image (a 1-step warm-up, then
   img2img at strength 0.6, inpaint at 1.0 with a centre-square mask and
   img2img at 1.0, each ``--steps`` steps truncated to ``round(steps *
   strength)``, with exact K1 / K2 / K3 launch counts and the image-encode,
   step and decode times): the inpaint's unmasked latent must equal the
   packed init latent, and the strength-1.0 latent phase 4's; then phase
   4c (Offloading.Full): phase 4's four components registered in a
   HostOffload (one exact-size pinned host buffer each; the process's
   VmRSS and the host's MemAvailable around it), one ``--steps`` image through
   ``forward_arrays`` with each on the card only around its stage, its
   latent and launches equal to phase 4's, then per component its bytes,
   its ``resident`` copy time and the allocated bytes around ``release``
   (which must fall by the component's bytes); and phase 4d
   (Offloading.Stream): phase 4's FLUX weights packed block by block into
   pinned host buffers (pack time, pinned GiB, VmRSS and MemAvailable
   around it), a 1-step warm-up, then the
   ``--steps`` image at lookahead 2 and at lookahead 1, each latent and its
   launches equal to phase 4's, with the step median, the peak device
   memory and ``StreamedFlux.overlap_report``; 4c and 4d fail when the
   host's MemAvailable is below their need;
6. a GGUF round trip at full width: the port's writer makes a BFL-named
   Q4_0 FLUX file with 1 double + 1 single block (random codes, f16
   scales), ``load_flux_transformer`` loads it onto the card (config and
   planes checked against the host decode of the same bytes), and one
   1024x1024 step runs through it with exact K4 launches;
7. the FLUX.1-dev GGUF paths, Q8_0 then Q4_0 in the BFL layout
   (fused qkv / linear1), encoders shared with phase 4: a 1-step warm-up,
   then one timed ``--steps``-step 1024x1024 image each, with exact launch
   counters, and a profiled 1-step image each as in phase 5;
8. config A: phase 4's q8t weights (same seed) through the loader's layout
   transform with every stream fused and grouped and
   DIFFUSION_RS_TPU_FUSED_ROPE=1, attention layout ``inkernel`` (K1, K8-s8, K7, and K2 on the fused T5),
   run as phase 7 runs its images; its latent is held against phase 4's;
9. config B: phase 7's Q4_0 weights (BFL layout, same seed) with
   ``fuse="grouped"`` and DIFFUSION_RS_TPU_FUSED_ROPE=1, attention layout
   ``seqmajor`` (K4, K8-affine, K6; config A's fused T5), run likewise; its
   latent is held against phase 7's Q4_0 latent;
10. config C (between phases 6 and 7, on phase 4's q8t weights): int8
   attention, DIFFUSION_RS_TPU_ATTN_S8=1 and ATTN_S8PV=1 (the prepass kernel
   ``flash_quant`` and the combined K9+K10 entry point), run as phase 7 runs
   its images, its latent held against phase 4's; then one 1-step image with
   each knob alone (K9, K10, each after the prepass) with exact launches,
   and ``s8pv_dropped_mass`` of the first attention's q/k;
11. configs D0 and D: FLUX.1-dev in nf4 (the JAX bench's exec format for its
   nf4 presets) made on the card, D0 in the default layout (K2), D the same
   weights after ``fuse="grouped"`` (K11 for the img/txt pairs), each run as
   phase 7 runs its images (config A's fused T5); D's latent must equal D0's
   (max-abs 0: grouping changes no weight and K11 equals K2 per group).

12. config F (between D0 and D): D0's nf4 weights with
   DIFFUSION_RS_TPU_QMM_FAST16=1 (K12 on FLUX and T5), its latent against
   D0's and the two step medians side by side;
13. the dense preset (dev-1024-bf16: bf16 FLUX.1-dev and T5-XXL
   made on the card; K3 alone), then configs E and E0: those weights through
   the loader's weight options (ISQ to q4_k on the card, a seeded imatrix
   over every FLUX linear written and read back, a seeded rank-16 LoRA on
   the attention projections as runtime terms; T5 follows isq), with
   DIFFUSION_RS_TPU_QMM_FAST16=1 (E: K13) and unset (E0: K4); the ISQ time,
   the weights' bytes, and a few full-size planes quantized on the CPU with
   the same function (equal without the imatrix, within the stated bands
   with it);
14. an ISQ file round trip at full width: a diffusers-layout directory (FLUX
   1 double + 1 single block, T5-XXL cut to 1 layer, CLIP-L and the VAE
   whole, bf16) written by the port, ``Pipeline(isq="q4_k", imatrix=,
   lora=)`` onto the card, its planes equal to the in-memory weight options
   on the same weights, and one 1024x1024 step with exact K13 launches;
   before that, the same directory through ``Pipeline(offloading=Full |
   Stream, device="cuda")``: where each component lands (pinned host
   copies; under Stream the encoders and the VAE on the card), the
   process's resident memory around each load, and a 1-step image whose
   latent, image and launches equal the resident load's; and one 1-step
   image from it through ``cli.main`` (a 1024x1024 PNG file);
15. config S, last: phase 4's weights (made again from their seed) and
   image sequence-parallel over two ranks that share the card
   (``parallel.spawn``, gloo through pinned host memory; the ranks open the
   weights through CUDA IPC, which keeps them allocated here until exit),
   each with its ring attention through K14: a tiny sp image against the
   CPU's plain versions, the timed ``--steps`` image with exact launches per
   rank and its latent against one rank's at the same depth, and a 1-step
   image under each int8 attention setting (K14's int8 entries); then
   config T on the same two ranks and weights, ``make_mesh(tp=2)``: tiny
   tp images (q8t; Q4_0; Q4_0 under DIFFUSION_RS_TPU_QMM_FAST16=1) against
   the CPU's plain versions, each launching its f32 entries, then FLUX.1-dev
   q8t with T5-XXL nf4 at full depth cut over tp (12 heads a rank; each
   rank copies its slices), a 1-step 256x256 warm-up and the timed image
   of ``min(--steps, 2)`` steps with exact launches and all-reduces (calls
   and bytes: 118 a forward, 48 a T5 encode) per rank, its latent against
   one rank's at the same steps; then the mesh serve on the same two ranks
   and weights: ``FluxServer(max_batch=2)`` on a ``make_mesh(dp=2)``
   pipeline (rank 0 takes the requests, the other follows its command
   stream), three 1024x1024 requests at ``min(--steps, 2)`` steps, each
   image against the single-process one, the bucket counters, exact
   launches per rank with K3 at the dp-local batch B1; then one 720x1280
   decode through the tiled VAE decode (two 128-pixel latent tiles);
16. the training dryrun: ``dryrun_multichip(8)`` (diffusion_rs_tpu_torch/
   dryrun.py) in a world of 8 spawned ranks on the card over gloo, at
   dp=2 sp=2 tp=2: the f32 training step's loss (finite, the same on every
   rank), no kernel launched by it, every tp-cut leaf's gradient nonzero,
   then the q8t ring step's exact launches per rank (K1, its f32 entry,
   K14) and ring hops.

Phases 7, 9, 11-13 and config S run 3 double + 6 single blocks at
FLUX.1-dev's widths (EARLIER_DEPTH; ``--full-depth`` restores 19 + 38);
config T and phases 4, 4c, 4d, 4e, 5, 8 and 10 run the full depth.

Phase 2 also holds K7's rotation pass (``rope_qk``) to
``rope_halfsplit_seqmajor`` bit for bit on column slices of a fused qkv at
S4608 and S4112 and times it (K7's rows also time it alone), holds the
default layout's attention prologue (``qk_norm_rope``: one launch per
block) to its plain route at 512 + 4096 rows and 24 heads (a double block
on linear outputs, a single block on qkv_mlp slices; v bit for bit, q and k
off in at most 0.1% of their elements) and times it beside its 0.0514 ms
byte bound, gives the K4
M1 rows (the modulation products) their device time from torch.profiler
beside the events' time, and holds K9, K10 and the combined entry point at
S4608, S4112 and S2304 (each also timed with its prepass kernel, and
beside the design bound that counts the second QK^T pass), the prepass
kernel ``flash_quant`` (k and v in one launch) against quantize_k /
quantize_v / v_kernel_layout at the same lengths,
K14's four entry points (K3's and the int8 modes' output with the per-row
log-sum-exp) at S2304 (config S's rows per rank), S4608 and S4112,
K11 at the grouped double-block shapes (against per-group K2 launches, max-abs
0), K2 at a FLUX shape, K3 at config T's 12 heads, the f32-output entries
of K1 (M4096 K1536 N3072, M4608 K7680 N3072: max-abs 0), K2 and K12 (M512
K5120 N4096), K4 and K13 (Q4_0, M4608 K7680 N3072) at config T's K-slices,
each beside its bf16 entry and the library's f32-output matmul, and the fast16 kernels K12 (nf4, at the T5 and D0
shapes) and K13 (Q4_0 and Q4_K at M4608 K3072 N21504; Q8_0, Q6_K, bnb int8
and a Q4_K plane with s == 0 groups untimed), each with its decoded weight
(the product with the identity) equal to the plain version's and timed
beside its f32-decode kernel on the same weights; phase 3 also runs the
tiny image with both int8 knobs, with nf4 FLUX plus ``fuse="grouped"``, and
from dense weights through the loader's ISQ (q4_k, imatrix, LoRA) under
DIFFUSION_RS_TPU_QMM_FAST16=1. Every image prints the capacity check's
estimate beside its measured peak.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without CUDA the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 rate outside the tensor cores

# summed-relative error bands. K1 (and K8-s8) is bit for bit with its plain
# version: same IEEE quotient and rounding, an exact integer dot, the same
# f32 fold order; its band is 0. K2 and K4 decode the same bf16 weight as
# their plain versions bit for bit (K2's decoded weight is checked through
# the identity), so only the f32 summation order differs. That order moves
# more outputs by a bf16 ulp as K grows: at K > 3072 (K8's mlp-out shape,
# K=12288) K4 and K8 are held to 1e-4 and to every element's
# summation-order bound, as tests/test_torch_cuda.py holds K4 at K=15360.
K1_TOL, K2_TOL, K3_TOL, K4_TOL = 0.0, 2e-3, 5e-4, 1e-5
K4_TOL_LONG_K = 1e-4
# The int8 attention kernels against their plain versions: the quantized
# codes and integer dots are exact in both; f32 summation orders and expf
# of the same arguments differ, as in K3 (tests/test_torch_cuda.py)
INT8_TOL = K3_TOL
INT8_MODES = {"flash_s8": (True, False), "flash_s8pv": (False, True),
              "flash_s8_s8pv": (True, True)}
ATTN_KNOBS = ("DIFFUSION_RS_TPU_ATTN_S8", "DIFFUSION_RS_TPU_ATTN_S8PV")
GGUF_KINDS = ("q8_0", "q4_0")
# The double blocks' grouped (K, N): qkv, proj, mlp in, mlp out; img M 4096
# and txt M 512 at 1024x1024. The mlp-in shape is the one timed.
GROUPED_SHAPES = ((3072, 9216), (3072, 3072), (3072, 12288), (12288, 3072))
GROUPED_MS = (4096, 512)
GROUPED_TIMED = (3072, 12288)
# Every stream fused, plus grouped. Not "all,grouped": the loader resolves
# fuse= as the JAX package does, where "all" stands for every stream only on
# its own, so "all,grouped" fuses just the img and txt streams.
FUSE_ALL_GROUPED = "img,txt,single,t5,grouped"


@contextlib.contextmanager
def env(**kv):
    """Set environment variables for the block (None unsets one), then
    restore them."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def attention_knobs(s8: bool, s8_pv: bool):
    """DIFFUSION_RS_TPU_ATTN_S8 / ATTN_S8PV for the block; the port reads
    each once and caches it, so the caches are cleared on entry and exit."""
    from diffusion_rs_tpu_torch.ops import attention

    def clear():
        attention._s8_default.cache_clear()
        attention._s8_pv_default.cache_clear()

    clear()
    try:
        with env(**dict(zip(ATTN_KNOBS, (str(int(s8)), str(int(s8_pv)))))):
            yield
    finally:
        clear()


def card_state() -> str:
    """The card's SM clock (and its maximum), power draw, temperature and
    active clock-throttle reasons, as nvidia-smi reads them: printed beside
    each timed image, since a card that slows under load moves every time."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True)
    return r.stdout.strip() if r.returncode == 0 else "not available"


def summed_rel(a, b) -> float:
    a = a.float()
    b = b.float()
    return float((a - b).abs().sum() / ((b.abs().sum()) + 1e-9))


def within_summation_order(y, ref, x, qt) -> bool:
    """Every element within what two f32 summation orders of the same
    products can give after the bf16 cast: one bf16 ulp plus
    2 K 2^-24 sum_k |x_k w_k| (tests/test_torch_cuda.py)."""
    import torch

    from diffusion_rs_tpu_torch.quant import dequantize

    y, ref = y.float(), ref.float()
    mag = x.float().abs() @ dequantize(qt, torch.float32).abs()
    tol = torch.maximum(y.abs(), ref.abs()) * 2.0 ** -7 + mag * (2 * qt.k * 2.0 ** -24)
    return bool(((y - ref).abs() <= tol).all())


def cuda_ms(fn, n_sets: int, iters: int = 24, warmup: int = 3, rounds: int = 3) -> float:
    """Mean ms per call of ``fn(i)`` over ``iters`` calls, cycling over
    ``n_sets`` input sets so the weights come from device memory and not
    from L2; the median of ``rounds`` such means, so that one slow moment
    of the card does not make the figure."""
    import torch

    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(rounds):
        start.record()
        for i in range(iters):
            fn(i % n_sets)
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def bound(ops: float, peak_ops: float, nbytes: float, extra_ops_ms: float = 0.0):
    """Least time (ms) for ``ops`` at ``peak_ops`` (plus ``extra_ops_ms`` of
    work at another rate) or ``nbytes`` at the memory rate, and which bounds."""
    t_ops = ops / peak_ops * 1e3 + extra_ops_ms
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_device_ms(fn, n_sets: int, names, iters: int = 24) -> dict:
    """Device ms per call of ``fn(i)`` of each kernel whose name holds one of
    ``names``, from torch.profiler over ``iters`` calls (after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % n_sets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_sets)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {name: sum(e.device_time_total for e in events if name in e.key) / 1e3 / iters
            for name in names}


def int8_gemm_ms(x, qts, bk: int, n_sets: int):
    """torch._int_mm (cuBLASLt's int8 GEMM) on K1's int8 operands, the
    activation codes and the weight plane: the product without K1's
    per-K-tile fold or its quantize pass, so not the library row. Timed
    with the plane as stored ([K, N], row-major) and as a column-major copy
    (the layout cuBLASLt's int8 kernels take without a transpose); None
    where cuBLASLt does not take the shape (M <= 16)."""
    import torch

    m, k = x.shape
    xf = x.float().view(m, k // bk, bk)
    ax = xf.abs().amax(-1, keepdim=True)
    sx = torch.where(ax == 0, torch.ones_like(ax), ax / torch.full_like(ax, 127.0))
    xq = torch.round(xf / sx).to(torch.int8).view(m, k)
    try:
        torch._int_mm(xq, qts[0].packed)
    except RuntimeError as e:
        print(f"  torch._int_mm refuses M{m} K{k}: {str(e).splitlines()[0][:120]}")
        return None
    row_major = cuda_ms(lambda i: torch._int_mm(xq, qts[i].packed), n_sets)
    cols = [qt.packed.t().contiguous().t() for qt in qts]
    col_major = cuda_ms(lambda i: torch._int_mm(xq, cols[i]), n_sets)
    return {"row_major_ms": row_major, "col_major_ms": col_major}


def check_qmm(kind: str, m: int, k: int, n: int, gen, tol: float, detail: bool = True):
    """One quantized-matmul kernel against its plain version at [m, k] x [k, n]
    (K1 bit for bit; K2 also through the identity: its decoded weight equal
    to ``dequantize(qt, f32).to(bf16)``). ``detail`` False skips the
    profiler's device times and K1's int8-GEMM row (the serve phase's rows
    report the events' times only)."""
    import torch

    from diffusion_rs_tpu_torch.ops import qmatmul
    from diffusion_rs_tpu_torch.quant import dequantize
    from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

    # bytes of one weight set: codes plus f32 scale (and bias) planes
    set_bytes = {"q8t": k * n, "nf4": k * n / 2,
                 "q8_0": k * n * (1 + 4 / 32), "q4_0": k * n * (0.5 + 8 / 32)}[kind]
    # enough weight sets that one pass over them overflows the 50 MB L2
    n_sets = max(2, math.ceil(100e6 / set_bytes))
    qts = [random_qtensor(gen, k, n, kind=kind, device="cuda") for _ in range(n_sets)]
    if kind in GGUF_KINDS:  # f16-rounded per-group scales from the factory
        kern, plain = qmatmul.qmm_affine, lambda x, qt: qmatmul.qmm_dequant_plain(
            x, qt, torch.bfloat16)
        ops, peak = 2.0 * m * k * n, PEAK_BF16_FLOPS
        nbytes = m * k * 2 + set_bytes + m * n * 2
    elif kind == "q8t":
        for qt in qts:  # per-(tile, column) scales that differ
            qt.scale.uniform_(0.5e-3, 2e-3, generator=gen)
        kern, plain = qmatmul.qmm_s8, lambda x, qt: qmatmul.qmm_s8_plain(
            x, qt.packed, qt.scale, torch.bfloat16)
        ops, peak = 2.0 * m * k * n, PEAK_INT8_OPS
        nbytes = m * k * 2 + k * n + qts[0].scale.numel() * 4 + m * n * 2
    else:
        for qt in qts:
            qt.scale.uniform_(0.01, 0.03, generator=gen)
        kern, plain = qmatmul.qmm_nf4, lambda x, qt: qmatmul.qmm_dequant_plain(
            x, qt, torch.bfloat16)
        ops, peak = 2.0 * m * k * n, PEAK_BF16_FLOPS
        nbytes = m * k * 2 + k * n // 2 + qts[0].scale.numel() * 4 + 64 + m * n * 2
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    y = kern(x, qts[0], torch.bfloat16)
    torch.cuda.synchronize()
    ref = plain(x, qts[0])
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    if not (err <= tol) or not torch.isfinite(y).all():
        raise SystemExit(f"{kind} kernel disagrees with its plain version at "
                         f"M={m} K={k} N={n}: summed-rel {err:.3e} > {tol:g}, "
                         f"max-abs {max_abs:.3e}")
    extra = {}
    if kind == "nf4":
        eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
        extra["decoded_max_abs"] = float((kern(eye, qts[0], torch.bfloat16).float() - dequantize(
            qts[0], torch.float32).to(torch.bfloat16).float()).abs().max())
        del eye
        if extra["decoded_max_abs"] != 0.0:
            raise SystemExit(f"qmm_nf4 decodes another weight than dequantize at K={k} N={n}: "
                             f"max-abs {extra['decoded_max_abs']:.3e}")
    w_deq = [dequantize(qt, torch.bfloat16) for qt in qts]
    ms = cuda_ms(lambda i: kern(x, qts[i], torch.bfloat16), n_sets)
    plain_ms = cuda_ms(lambda i: plain(x, qts[i]), n_sets, iters=4, warmup=1)
    lib_ms = cuda_ms(lambda i: torch.matmul(x, w_deq[i]), n_sets)
    if detail and kind in GGUF_KINDS and m <= 64:  # byte-bound: device beside events' time
        extra["device_ms"] = kernel_device_ms(lambda i: kern(x, qts[i], torch.bfloat16), n_sets,
                                              ("qmm_affine_kernel",))["qmm_affine_kernel"]
    if detail and kind == "q8t":
        passes = kernel_device_ms(lambda i: kern(x, qts[i], torch.bfloat16), n_sets,
                                  ("quantize_rows_kernel", "qmm_s8_kernel"))
        extra["pass1_ms"] = passes["quantize_rows_kernel"]
        extra["pass2_ms"] = passes["qmm_s8_kernel"]
        extra["int8_gemm_ms"] = int8_gemm_ms(x, qts, qts[0].group, n_sets)
    b_ms, b_by = bound(ops, peak, nbytes)
    return dict(shape=f"M{m} K{k} N{n}" + (f" {kind}" if kind in GGUF_KINDS else ""),
                summed_rel=err, max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, **extra)


def check_affine_format(fmt: str, m: int, k: int, n: int, gen):
    """K4 against its plain version (untimed) for a format the synthetic
    factory does not make: GGUF blocks from the port's encoders, or bnb
    int8 codes and row scales, canonicalized on the host."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch.ops import qmatmul
    from diffusion_rs_tpu_torch.quant.bnb import bnb_int8_to_canonical
    from diffusion_rs_tpu_torch.quant.gguf_quants import ENCODERS, gguf_to_canonical

    rng = np.random.default_rng(k + n)
    if fmt == "int8":
        qt = bnb_int8_to_canonical(rng.integers(-127, 128, size=(n, k), dtype=np.int8),
                                   rng.uniform(0.5, 2.0, size=n).astype(np.float32))
    else:
        w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
        qt = gguf_to_canonical(fmt, ENCODERS[fmt](w), (n, k))
    qt = qt.map(lambda t: t.cuda())
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    y = qmatmul.quantized_matmul(x, qt)
    torch.cuda.synchronize()
    ref = qmatmul.qmm_dequant_plain(x, qt, torch.bfloat16)
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    if not (err <= K4_TOL) or not torch.isfinite(y).all():
        raise SystemExit(f"qmm_affine disagrees with its plain version for {fmt} at "
                         f"M={m} K={k} N={n}: summed-rel {err:.3e} > {K4_TOL:g}")
    return dict(shape=f"M{m} K{k} N{n} {fmt} (group {qt.group}, bias "
                      f"{'yes' if qt.bias is not None else 'no'})",
                summed_rel=err, max_abs_err=max_abs)


def fast16_weights(kind: str, k: int, n: int, gen):
    """A weight for the fast16 kernels on the card: nf4 from the synthetic
    factory with per-group scales that differ, Q4_0 from it with f16-rounded
    scales, Q4_K from the device quantizer on a normal [K, N] plane."""
    import torch

    from diffusion_rs_tpu_torch.quant.gguf_quants import quantize_canonical
    from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

    if kind == "q4_k":
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        return quantize_canonical(w, "q4_k")
    qt = random_qtensor(gen, k, n, kind=kind, device="cuda")
    if kind == "nf4":
        qt.scale.uniform_(0.01, 0.03, generator=gen)
    return qt


def check_fast16(kind: str, m: int, k: int, n: int, gen):
    """K12 (nf4) or K13 (Q4_0, Q4_K) at [m, k] x [k, n]: its decoded weight
    (the product with the identity) equal to the plain fast16 decode
    (max-abs 0), its output within K2's / K4's band of the plain version;
    then timed against the f32-decode kernel (K2 / K4) on the same weights,
    the plain version and one bf16 torch.matmul on the decoded weight."""
    import torch

    from diffusion_rs_tpu_torch.ops import qmatmul

    codebook = kind == "nf4"
    kern = qmatmul.qmm_nf4_fast16 if codebook else qmatmul.qmm_affine_fast16
    f32_kern = qmatmul.qmm_nf4 if codebook else qmatmul.qmm_affine
    tol = K2_TOL if codebook else K4_TOL
    bf16 = torch.bfloat16
    set_bytes = k * n * (0.5 + 4 / 64) if codebook else k * n * (0.5 + 8 / 32)
    n_sets = max(2, math.ceil(100e6 / set_bytes))
    qts = [fast16_weights(kind, k, n, gen) for _ in range(n_sets)]
    eye = torch.eye(k, device="cuda", dtype=bf16)
    w16 = qmatmul.dequantize_fast16(qts[0], bf16)
    decoded = float((kern(eye, qts[0], bf16).float() - w16.float()).abs().max())
    del eye
    x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
    y = kern(x, qts[0], bf16)
    torch.cuda.synchronize()
    ref = qmatmul.qmm_dequant_fast16_plain(x, qts[0], bf16)
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    vs_f32 = summed_rel(f32_kern(x, qts[0], bf16), ref)
    name = kern.__name__
    if decoded != 0.0:
        raise SystemExit(f"{name} decodes another weight than its plain version at K={k} "
                         f"N={n}: max-abs {decoded:.3e}")
    if not (err <= tol) or not torch.isfinite(y).all():
        raise SystemExit(f"{name} disagrees with its plain version at M={m} K={k} N={n}: "
                         f"summed-rel {err:.3e} > {tol:g}")
    deq = [qmatmul.dequantize_fast16(qt, bf16) for qt in qts]
    row = dict(shape=f"M{m} K{k} N{n} {kind}", summed_rel=err, max_abs_err=max_abs,
               decoded_max_abs=decoded, vs_f32_decode=vs_f32)
    row["ms"] = cuda_ms(lambda i: kern(x, qts[i], bf16), n_sets)
    row["f32_decode_ms"] = cuda_ms(lambda i: f32_kern(x, qts[i], bf16), n_sets)
    row["plain_ms"] = cuda_ms(lambda i: qmatmul.qmm_dequant_fast16_plain(x, qts[i], bf16),
                              n_sets, iters=4, warmup=1)
    row["library_ms"] = cuda_ms(lambda i: torch.matmul(x, deq[i]), n_sets)
    row["bound_ms"], row["bound_by"] = bound(2.0 * m * k * n, PEAK_BF16_FLOPS,
                                             m * k * 2 + set_bytes + m * n * 2)
    return row


def check_fast16_format(fmt: str, m: int, k: int, n: int, gen):
    """K13 against its plain version (untimed) for Q8_0, Q6_K (device
    quantizer), bnb int8 and a Q4_K plane with s == 0 groups (a super-block
    of values in [-4e-6, -2e-6] in 16 columns: d underflows f16, dmin does
    not): decoded weight max-abs 0, output within K4's band."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch.ops import qmatmul
    from diffusion_rs_tpu_torch.quant.bnb import bnb_int8_to_canonical
    from diffusion_rs_tpu_torch.quant.gguf_quants import quantize_canonical

    bf16 = torch.bfloat16
    if fmt == "int8":
        rng = np.random.default_rng(k + n)
        qt = bnb_int8_to_canonical(rng.integers(-127, 128, size=(n, k), dtype=np.int8),
                                   rng.uniform(0.5, 2.0, size=n).astype(np.float32))
        qt = qt.map(lambda t: t.cuda())
    else:
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        if fmt == "q4_k_zero_scales":
            w[:256, :16] = -2e-6 - 2e-6 * torch.rand((256, 16), generator=gen, device="cuda")
        qt = quantize_canonical(w, fmt.removesuffix("_zero_scales"))
    zero = int((qt.scale == 0).sum())
    if fmt == "q4_k_zero_scales" and not (zero and bool((qt.bias[qt.scale == 0] != 0).any())):
        raise SystemExit("the Q4_K plane holds no s == 0 groups with a bias")
    eye = torch.eye(k, device="cuda", dtype=bf16)
    decoded = float((qmatmul.qmm_affine_fast16(eye, qt, bf16).float()
                     - qmatmul.dequantize_fast16(qt, bf16).float()).abs().max())
    x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
    y = qmatmul.qmm_affine_fast16(x, qt, bf16)
    torch.cuda.synchronize()
    ref = qmatmul.qmm_dequant_fast16_plain(x, qt, bf16)
    err = summed_rel(y, ref)
    if decoded != 0.0 or not (err <= K4_TOL) or not torch.isfinite(y).all():
        raise SystemExit(f"qmm_affine_fast16 disagrees with its plain version for {fmt}: "
                         f"decoded max-abs {decoded:.3e}, summed-rel {err:.3e}")
    return dict(shape=f"M{m} K{k} N{n} {fmt} (group {qt.group}, bias "
                      f"{'yes' if qt.bias is not None else 'no'}, {zero} zero scales)",
                summed_rel=err, max_abs_err=float((y.float() - ref.float()).abs().max()),
                decoded_max_abs=decoded)


# The f32-output entries (a row-parallel linear's partial product under
# tp, before its all-reduce): entry -> weight kind. K1's is bit for bit with
# its plain version; the decoding kernels hold every element within the f32
# summation-order bound of theirs, 2 K 2^-24 sum |x w| (no bf16 cast here).
F32_ENTRIES = {"qmm_s8": "q8t", "qmm_nf4": "nf4", "qmm_nf4_fast16": "nf4",
               "qmm_affine": "q4_0", "qmm_affine_fast16": "q4_0"}


def check_qmm_f32(name: str, m: int, k: int, n: int, gen):
    """Kernel ``name`` storing f32 (its ``<name>_f32`` entry) at [m, k] x
    [k, n], the K-slices of the row-parallel linears at tp=2: against its
    plain version in f32 (K1 max-abs 0, the others within the summation-order
    bound), its output cast to bf16 equal to the bf16 entry's bit for bit;
    timed beside the bf16 entry on the same weights, the plain version and
    the library's matmul with an f32 output on the decoded weight."""
    import torch

    from diffusion_rs_tpu_torch.ops import qmatmul
    from diffusion_rs_tpu_torch.quant import dequantize
    from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

    kind = F32_ENTRIES[name]
    fast16 = name.endswith("fast16")
    kern = getattr(qmatmul, name)
    f32, bf16 = torch.float32, torch.bfloat16
    set_bytes = {"q8t": k * n + k // 256 * n * 4, "nf4": k * n * (0.5 + 4 / 64),
                 "q4_0": k * n * (0.5 + 8 / 32)}[kind]
    n_sets = max(2, math.ceil(100e6 / set_bytes))
    if kind == "q8t":
        qts = [random_qtensor(gen, k, n, kind="q8t", device="cuda") for _ in range(n_sets)]
        for qt in qts:
            qt.scale.uniform_(0.5e-3, 2e-3, generator=gen)
        plain = lambda x, qt: qmatmul.qmm_s8_plain(x, qt.packed, qt.scale, f32)  # noqa: E731
        peak = PEAK_INT8_OPS
    else:
        qts = [fast16_weights(kind, k, n, gen) for _ in range(n_sets)]
        plain_fn = qmatmul.qmm_dequant_fast16_plain if fast16 else qmatmul.qmm_dequant_plain
        plain = lambda x, qt: plain_fn(x, qt, f32)  # noqa: E731
        peak = PEAK_BF16_FLOPS
    x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
    y = kern(x, qts[0], f32)
    torch.cuda.synchronize()
    ref = plain(x, qts[0])
    same_as_bf16 = torch.equal(y.to(bf16), kern(x, qts[0], bf16))
    max_abs = float((y - ref).abs().max())
    if kind == "q8t":
        ok = max_abs == 0.0
    else:
        w = (qmatmul.dequantize_fast16(qts[0], bf16) if fast16
             else dequantize(qts[0], f32).to(bf16)).float()
        ok = bool(((y - ref).abs() <= (x.float().abs() @ w.abs()) * (2 * k * 2.0 ** -24)).all())
        del w
    if not (ok and same_as_bf16 and y.dtype == f32 and torch.isfinite(y).all()):
        raise SystemExit(f"{name}_f32 disagrees at M={m} K={k} N={n}: max-abs {max_abs:.3e} "
                         f"against its plain version, bf16 cast equal to the bf16 entry "
                         f"{same_as_bf16}")
    deq = [(qmatmul.dequantize_fast16(qt, bf16) if fast16 else dequantize(qt, bf16))
           for qt in qts]
    try:  # the library's f32-output matmul of bf16 operands, where torch has it
        torch.mm(x, deq[0], out_dtype=f32)
        lib = lambda i: torch.mm(x, deq[i], out_dtype=f32)  # noqa: E731
        note = "torch.mm(x, w, out_dtype=torch.float32) on the decoded bf16 weight"
    except (TypeError, RuntimeError):
        lib = lambda i: torch.matmul(x.float(), deq[i].float())  # noqa: E731
        note = "torch.matmul in f32 on the decoded weight (no out_dtype in this torch)"
    row = dict(shape=f"M{m} K{k} N{n} {kind}", summed_rel=summed_rel(y, ref),
               max_abs_err=max_abs, library_note=note)
    row["ms"] = cuda_ms(lambda i: kern(x, qts[i], f32), n_sets)
    row["bf16_entry_ms"] = cuda_ms(lambda i: kern(x, qts[i], bf16), n_sets)
    row["plain_ms"] = cuda_ms(lambda i: plain(x, qts[i]), n_sets, iters=4, warmup=1)
    row["library_ms"] = cuda_ms(lib, n_sets)
    row["bound_ms"], row["bound_by"] = bound(2.0 * m * k * n, peak,
                                             m * k * 2 + set_bytes + m * n * 4)
    return row


def check_flash(s_q: int, gen, b: int = 1, h: int = 24):
    import torch
    import torch.nn.functional as F

    from diffusion_rs_tpu_torch.ops import flash

    d = 128
    q, k, v = (torch.randn((b, h, s_q, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    y = flash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash.flash_attention_plain(q, k, v, scale).transpose(1, 2).reshape(b, s_q, h * d)
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    if not (err <= K3_TOL) or not torch.isfinite(y).all():
        raise SystemExit(f"flash kernel disagrees with its plain version at "
                         f"S={s_q}: summed-rel {err:.3e} > {K3_TOL:g}")
    ms = cuda_ms(lambda i: flash.flash_fwd(q, k, v, scale), 1)
    plain_ms = cuda_ms(lambda i: flash.flash_attention_plain(q, k, v, scale), 1,
                       iters=3, warmup=1)
    lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(q, k, v), 1)
    ops = 4.0 * b * h * s_q * s_q * d
    nbytes = 4 * b * h * s_q * d * 2
    b_ms, b_by = bound(ops, PEAK_BF16_FLOPS, nbytes)
    return dict(shape=f"B{b} H{h} S{s_q} D{d}", summed_rel=err, max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def flux_tables(s: int):
    """Expanded RoPE tables [1, s, 128] of FLUX positions on the card: s -
    4096 text rows at 0, then the 64x64 latent grid of a 1024x1024 image."""
    import torch

    from diffusion_rs_tpu_torch.ops.rope import expand_rope_tables, rope_tables

    r = torch.arange(4096, device="cuda")
    img = torch.stack([torch.zeros_like(r), r // 64, r % 64], -1).float()
    ids = torch.cat([torch.zeros((s - 4096, 3), device="cuda"), img])[None]
    return expand_rope_tables(*rope_tables(ids, (16, 56, 56)))


def check_flash_seqmajor(s_q: int, gen, rope: bool):
    """K6 (``rope=False``) or K7 against its plain version on seq-major
    [1, S, 24*128] operands; K7 also against K6 on plain-rotated q/k, which
    must agree bit for bit."""
    import torch
    import torch.nn.functional as F

    from diffusion_rs_tpu_torch.ops import flash

    b, h, d = 1, 24, 128
    q, k, v = (torch.randn((b, s_q, h * d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    ce, se = flux_tables(s_q)
    qr = flash.rope_halfsplit_seqmajor(q, ce, se, d)
    kr = flash.rope_halfsplit_seqmajor(k, ce, se, d)

    def heads(t):
        return t.view(b, s_q, h, d).transpose(1, 2)

    if rope:
        def kern():
            return flash.flash_rope(q, k, v, ce, se, ce, se, scale)

        def plain():
            return flash.flash_rope_plain(q, k, v, ce, se, ce, se, d, scale)

        lib_args = (heads(qr), heads(kr), heads(v))  # rotation excluded
    else:
        def kern():
            return flash.flash_sm(q, k, v, scale)

        def plain():
            return flash.flash_sm_plain(q, k, v, d, scale)

        lib_args = (heads(q), heads(k), heads(v))
    y = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    name = "flash_rope" if rope else "flash_sm"
    if not (err <= K3_TOL) or not torch.isfinite(y).all():
        raise SystemExit(f"{name} disagrees with its plain version at S={s_q}: "
                         f"summed-rel {err:.3e} > {K3_TOL:g}")
    row = dict(shape=f"B{b} H{h} S{s_q} D{d}", summed_rel=err, max_abs_err=max_abs)
    if rope:
        k6 = flash.flash_sm(qr, kr, v, scale)
        row["vs_k6_max_abs"] = float((y.float() - k6.float()).abs().max())
        if row["vs_k6_max_abs"] != 0.0:
            raise SystemExit(f"flash_rope differs from flash_sm on plain-rotated q/k at "
                             f"S={s_q}: max-abs {row['vs_k6_max_abs']:.3e}")
    row["ms"] = cuda_ms(lambda i: kern(), 1)
    if rope:  # K7 = the rotation pass + K6's body; the pass alone
        row["rope_ms"] = cuda_ms(lambda i: flash.rope_qk(q, k, ce, se, ce, se), 1)
    row["plain_ms"] = cuda_ms(lambda i: plain(), 1, iters=3, warmup=1)
    row["library_ms"] = cuda_ms(lambda i: F.scaled_dot_product_attention(*lib_args), 1)
    ops = 4.0 * b * h * s_q * s_q * d
    nbytes = 4 * b * s_q * h * d * 2
    rot_ms = 0.0
    if rope:  # the tables, and 3 f32 operations per rotated q and k element
        nbytes += 2 * b * s_q * d * 4
        rot_ms = 2 * 3.0 * b * s_q * h * d / PEAK_F32_FLOPS * 1e3
    row["bound_ms"], row["bound_by"] = bound(ops, PEAK_BF16_FLOPS, nbytes, rot_ms)
    return row


def check_qk_norm_rope(kind: str):
    """The default layout's attention prologue (``qk_norm_rope``) against its
    plain route at FLUX.1-dev's 512 + 4096 rows, 24 heads: a double block
    (txt then img, linear outputs) or a single block (column slices of the
    fused qkv_mlp projection). v bit for bit; q and k differ in at most
    0.1% of their elements, each rotated pair within 2^-5 of its norm (the
    sum of squares' order moves 1 / rms by an f32 ulp, the two bf16
    roundings and the rotation carry that on). Bound: its bytes (q, k, v
    read and written once, the cos / sin tables read once): 0.0514 ms. Its
    inputs come from a generator of its own, so the kernel phase's other
    checks draw what they drew without it."""
    import torch

    from diffusion_rs_tpu_torch.ops import rope

    gen = torch.Generator(device="cuda").manual_seed({"double": 18, "single": 19}[kind])

    b, h, d, s_txt, s = 1, 24, 128, 512, 4608
    n = h * d
    tables = flux_tables(s)
    cos, sin = tables[0][..., :d // 2].contiguous(), tables[1][..., d // 2:].contiguous()

    def scales():
        return tuple((0.5 + torch.rand(d, generator=gen, device="cuda")).bfloat16()
                     for _ in range(2))

    if kind == "double":
        streams = [(*(torch.randn((b, rows, n), generator=gen, device="cuda").bfloat16()
                      for _ in range(3)), *scales()) for rows in (s_txt, s - s_txt)]
    else:
        fused = torch.randn((b, s, 7 * n), generator=gen, device="cuda").bfloat16()
        streams = [(fused[..., :n], fused[..., n:2 * n], fused[..., 2 * n:3 * n], *scales())]
    got = rope.qk_norm_rope(streams, cos, sin, h)
    torch.cuda.synchronize()
    want = rope.qk_norm_rope_plain(streams, cos, sin, h)
    if not torch.equal(got[2], want[2]):
        raise SystemExit(f"qk_norm_rope ({kind}): v differs from the plain route")
    diffs = []
    for x, y in zip(got[:2], want[:2]):
        x, y = x.float(), y.float()
        xp, yp = x.unflatten(-1, (-1, 2)), y.unflatten(-1, (-1, 2))
        norm = torch.maximum(xp.norm(dim=-1), yp.norm(dim=-1))[..., None]
        if not ((xp - yp).abs() <= norm * 2.0 ** -5).all():
            raise SystemExit(f"qk_norm_rope ({kind}): a rotated q/k pair off the plain route "
                             f"by more than 2^-5 of its norm")
        diffs.append(float((x != y).float().mean()))
    if max(diffs) > 1e-3:
        raise SystemExit(f"qk_norm_rope ({kind}): {max(diffs):.2e} of q/k elements differ")
    row = dict(shape=f"B{b} H{h} S{s_txt}+{s - s_txt} D{d} ({kind}"
                     f"{', qkv_mlp slices' if kind == 'single' else ''})",
               summed_rel=summed_rel(torch.cat([g.float().flatten() for g in got[:2]]),
                                     torch.cat([w.float().flatten() for w in want[:2]])),
               max_abs_err=max(float((x.float() - y.float()).abs().max())
                               for x, y in zip(got, want)),
               differing_share=max(diffs))
    # device time from the profiler: back to back, the wrapper's host time
    # (its checks, three allocations, the launch) exceeds the kernel's, so
    # the events' time per call is the host's (wrapper_ms)
    row["ms"] = kernel_device_ms(lambda i: rope.qk_norm_rope(streams, cos, sin, h), 1,
                                 ("qk_norm_rope_kernel",))["qk_norm_rope_kernel"]
    row["wrapper_ms"] = cuda_ms(lambda i: rope.qk_norm_rope(streams, cos, sin, h), 1)
    row["plain_ms"] = cuda_ms(lambda i: rope.qk_norm_rope_plain(streams, cos, sin, h), 1)
    row["library_ms"] = None
    nbytes = 6 * b * s * n * 2 + 2 * b * s * (d // 2) * 4
    row["bound_ms"], row["bound_by"] = bound(0.0, PEAK_F32_FLOPS, nbytes)
    print(f"qk_norm_rope ({kind}) {row['shape']}: {row['ms']:.4f} ms on the device, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} of "
          f"it; {row['wrapper_ms']:.4f} ms a call back to back (the wrapper's host time); "
          f"plain route {row['plain_ms']:.4f} ms; share of q/k elements that differ "
          f"{max(diffs):.2e}")
    return row


def check_rope_qk(s: int, gen):
    """K7's rotation pass (``rope_qk``) against its plain version,
    ``rope_halfsplit_seqmajor`` on q and k, bit for bit (``torch.equal``), on
    seq-major [1, S, 24*128] column slices of a fused qkv at FLUX positions.
    Bound: its bytes (q and k in and out, the cos and sin halves of the
    tables, read once); no PyTorch call rotates."""
    import torch

    from diffusion_rs_tpu_torch.ops import flash

    b, h, d = 1, 24, 128
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k = qkv[..., :h * d], qkv[..., h * d:2 * h * d]
    ce, se = flux_tables(s)
    qr, kr = flash.rope_qk(q, k, ce, se, ce, se)
    torch.cuda.synchronize()

    def plain():
        return (flash.rope_halfsplit_seqmajor(q, ce, se, d),
                flash.rope_halfsplit_seqmajor(k, ce, se, d))

    ref_q, ref_k = plain()
    if not (torch.equal(qr, ref_q) and torch.equal(kr, ref_k)):
        raise SystemExit(f"rope_qk differs from rope_halfsplit_seqmajor at S={s}")
    row = dict(shape=f"B{b} H{h} S{s} D{d} (q and k)", summed_rel=0.0, max_abs_err=0.0)
    row["ms"] = cuda_ms(lambda i: flash.rope_qk(q, k, ce, se, ce, se), 1)
    row["plain_ms"] = cuda_ms(lambda i: plain(), 1)
    row["library_ms"] = None
    nbytes = 2 * (2 * b * s * h * d * 2) + 2 * b * s * (d // 2) * 4
    row["bound_ms"], row["bound_by"] = bound(2 * 6.0 * b * s * h * d / 2, PEAK_F32_FLOPS, nbytes)
    return row


def sass_classes() -> dict:
    """Per kernel function of the built libraries (anonymous-namespace
    hash stripped): its instruction count and its warpgroup (HGMMA, IGMMA)
    and warp-level (HMMA, IMMA) tensor-core instructions, from cuobjdump."""
    import re

    from diffusion_rs_tpu_torch.ops import _cuda

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = {}
    for src in _cuda.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_cuda._lib_path(src))], check=True,
                              capture_output=True, text=True).stdout
        name = None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                # drop the anonymous namespace (_ZN<length>_GLOBAL__N__<file hash>...)
                name = re.sub(r"^_ZN(\d+)(_GLOBAL__N__\w+)",
                              lambda a: a.group(2)[int(a.group(1)):], m.group(1))
                out[name] = dict.fromkeys(("instructions", "HGMMA", "IGMMA", "HMMA", "IMMA"), 0)
            elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                out[name]["instructions"] += 1
                for op in ("HGMMA", "IGMMA", "HMMA", "IMMA"):
                    out[name][op] += bool(re.search(r"\b" + op + r"\.", line))
    return out


# kernel functions on Hopper's warpgroup MMA (no mma.sync), by name: K1 /
# K8-s8, K2 / K11 / K12, the bf16 flash body, the affine body and the int8
# flash body
WGMMA_KERNELS = ("qmm_s8_kernel", "qmm_nf4_kernel", "flash_wg_kernel", "qmm_affine_kernel",
                 "flash_int8_kernel", "flash_int8_lse_kernel")


def check_sass() -> str:
    """The SASS line, per kernel function [instructions, HGMMA, IGMMA, HMMA,
    IMMA]: every wgmma body holds HGMMA or IGMMA and no HMMA or IMMA (the
    int8 flash body IGMMA, with HGMMA for its bf16 halves), and no kernel
    holds mma.sync. Whether a body's instructions changed between two
    checkouts is tools/torch_sass_compare.py's to say."""
    classes = sass_classes()
    bad = [name for name, c in classes.items()
           if c["HMMA"] + c["IMMA"]
           or (any(k in name for k in WGMMA_KERNELS) and not c["HGMMA"] + c["IGMMA"])
           or ("flash_int8" in name and not c["IGMMA"])]
    found = {k: sum(k in n for n in classes) for k in WGMMA_KERNELS}
    if bad or not all(found.values()):
        raise SystemExit(f"SASS: unexpected tensor-core instructions in {bad} (kernels found "
                         f"{found})")
    return json.dumps({name[:72]: [c["instructions"], c["HGMMA"], c["IGMMA"], c["HMMA"],
                                   c["IMMA"]] for name, c in sorted(classes.items())})


def check_flash_int8(s_q: int, gen, entry: str):
    """K9 (``flash_s8``), K10 (``flash_s8pv``) or both (``flash_s8_s8pv``)
    against the plain version at B1 H24 S ``s_q``. ``ms`` times the kernel
    alone on inputs the prepass kernel made once (and the body on them must
    equal the wrapper's output); ``with_prepass_ms`` times the wrapper,
    prepass kernel and body. Bound: the reference function's 4 B H S^2 D
    operations, the int8 halves at the int8 rate and the others at the bf16
    rate; ``design_bound_ms`` adds the body's second QK^T pass under s8_pv.
    No PyTorch call computes int8 attention: the library time is bf16
    scaled_dot_product_attention, a different function."""
    import torch
    import torch.nn.functional as F

    from diffusion_rs_tpu_torch.ops import _cuda, flash

    s8, s8_pv = INT8_MODES[entry]
    b, h, d = 1, 24, 128
    q, k, v = (torch.randn((b, h, s_q, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    y = flash.flash_int8(q, k, v, scale, s8, s8_pv)
    torch.cuda.synchronize()
    ref = flash.flash_int8_plain(q, k, v, scale, s8, s8_pv).transpose(1, 2).reshape(
        b, s_q, h * d)
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    if not (err <= INT8_TOL) or not torch.isfinite(y).all():
        raise SystemExit(f"{entry} disagrees with its plain version at S={s_q}: "
                         f"summed-rel {err:.3e} > {INT8_TOL:g}")
    out = torch.empty_like(y)
    keep, args = int8_launch_args(q, k, v, scale, s8, s8_pv, out)
    row = dict(shape=f"B{b} H{h} S{s_q} D{d}", summed_rel=err, max_abs_err=max_abs)
    plan = flash.int8_flash_plan(b, h, s_q, s_q, flash.quant_block(s_q), s8, s8_pv)
    row["kv_tile_stages_smem"] = [plan.block_kv, plan.stages, plan.smem_bytes]
    if tuple(row["kv_tile_stages_smem"]) != _cuda.int8_layout(s8, s8_pv):
        raise SystemExit(f"{entry}: int8_flash_plan {row['kv_tile_stages_smem']} is not the "
                         f"compiled body's {_cuda.int8_layout(s8, s8_pv)}")
    row["ms"] = cuda_ms(lambda i: _cuda.launch(entry, *args, device=q.device), 1)
    if not torch.equal(out, y):
        raise SystemExit(f"{entry} on pre-quantized inputs differs from its wrapper")
    del keep
    row["with_prepass_ms"] = cuda_ms(lambda i: flash.flash_int8(q, k, v, scale, s8, s8_pv), 1)
    row["plain_ms"] = cuda_ms(lambda i: flash.flash_int8_plain(q, k, v, scale, s8, s8_pv), 1,
                              iters=2, warmup=1)
    row["library_ms"] = cuda_ms(lambda i: F.scaled_dot_product_attention(q, k, v), 1)
    row["library_note"] = "bf16 scaled_dot_product_attention, a different function"
    row["bound_ms"], row["bound_by"] = attention_bound(b, h, s_q, d, s8, s8_pv, lse=False)
    row["design_bound_ms"] = attention_bound(b, h, s_q, d, s8, s8_pv, lse=False, design=True)[0]
    return row


LSE_ENTRIES = {"flash_fwd_lse": (False, False),
               **{f"{e}_lse": mode for e, mode in INT8_MODES.items()}}
# K14's lse against its plain version: f32 summation orders and MUFU.EX2 (K3)
# or expf (the int8 body) against torch.exp, on log-sum-exps of magnitude ~10 (tests/test_torch_cuda.py)
LSE_TOL = 1e-3


def int8_launch_args(q, k, v, scale: float, s8: bool, s8_pv: bool, out, lse=None):
    """The int8 entry points' arguments for inputs the prepass kernel
    quantizes here, once: timing them times the body alone."""
    from diffusion_rs_tpu_torch.ops import flash

    b, h, s_q, _ = q.shape
    qb = flash.quant_block(k.shape[2])
    (kq, sk, _), (vt, sv, vm) = flash.quantize_kv(k if s8 else None, v if s8_pv else None, qb)
    kk = kq if s8 else k
    vv = vt if s8_pv else v
    keep = (kk, sk, vv, sv, vm)  # alive as long as the pointers are used
    ptrs = [q.data_ptr(), kk.data_ptr(), None if sk is None else sk.data_ptr(), vv.data_ptr(),
            None if sv is None else sv.data_ptr(), None if vm is None else vm.data_ptr(),
            out.data_ptr()] + ([] if lse is None else [lse.data_ptr()])
    return keep, (*ptrs, b, h, s_q, k.shape[2], qb, float(scale))


def attention_bound(b: int, h: int, s: int, d: int, s8: bool, s8_pv: bool, lse: bool,
                    design: bool = False):
    """The reference function's 4 B H S^2 D operations, the int8 halves at
    the int8 rate and the others at the bf16 rate, or the bytes: q in, k and
    v in (int8 where quantized, padded to the quantization block), the
    output, and the f32 lse. With ``design``, the int8 body's own bound:
    under s8_pv its first pass computes QK^T once more (int8 under s8, else
    bf16)."""
    from diffusion_rs_tpu_torch.ops import flash

    half = 2.0 * b * h * s * s * d
    skv_p = -(-s // flash.quant_block(s)) * flash.quant_block(s)
    nbytes = (b * h * s * d * 2 * 2
              + b * h * (skv_p if s8 else s) * d * (1 if s8 else 2)
              + b * h * (skv_p if s8_pv else s) * d * (1 if s8_pv else 2)
              + (b * h * s * 4 if lse else 0))
    again = design and s8_pv
    return bound(half * (s8 + s8_pv + (again and s8)), PEAK_INT8_OPS, nbytes,
                 half * (2 - s8 - s8_pv + (again and not s8)) / PEAK_BF16_FLOPS * 1e3)


def check_flash_quant(s: int, gen):
    """The prepass kernel (``flash_quant``: k and v of B1 H24 S ``s`` in one
    launch) against the plain versions (quantize_k, quantize_v,
    v_kernel_layout) on the same inputs: means within rtol 1e-6 (the kernel
    sums them in f64 in a fixed order, the plain version in f32), codes off
    by one on at most 1e-3 of the entries, padding zero. The scales follow
    the mean: a block's max |x - m| moves with m, so a mean k f32 ulps off
    the plain one moves the scale by up to about k ulps of the mean's size.
    So the scales are held bit for bit to the plain quantizer's on x centred
    at the kernel's own mean (max |x - m| / 127, IEEE), and their distance
    from the plain prepass's is reported (``scale_ulps``). ``ms``
    times the kernel alone, ``wrapper_ms`` quantize_kv (checks and
    allocations too). Bound: the bytes (k and v read once, codes, scales and
    means written); no PyTorch call computes it."""
    import torch

    from diffusion_rs_tpu_torch.ops import _cuda, flash

    b, h, d = 1, 24, 128
    k, v = ((torch.randn((b, h, s, d), generator=gen, device="cuda") * 0.5 + shift).to(
        torch.bfloat16) for shift in (0.1, 1.0))
    qb = flash.quant_block(s)
    got = flash.quantize_kv(k, v, qb)

    def plain():
        vq, sv, vm = flash.quantize_v(v, qb)
        return flash.quantize_k(k, qb), (flash.v_kernel_layout(vq), sv, vm)

    ref = plain()
    torch.cuda.synchronize()
    row = dict(shape=f"B{b} H{h} S{s} D{d} (k and v)")
    worst = {"mean_max_abs": 0.0, "scale_ulps": 0, "codes_off": 0.0, "max_abs_err": 0}
    for which, x, (codes, scales, mean), (rc, rs, rm) in zip("kv", (k, v), got, ref):
        src = torch.arange(codes.shape[2 if which == "k" else 3], device=codes.device)
        if which == "v":  # the source row of each position of v_kernel_layout
            src = flash.v_kernel_layout(src[None, None, :, None])[0, 0, 0]
        pad = codes[:, :, src >= s] if which == "k" else codes[..., src >= s]
        diff = (codes.int() - rc.int()).abs()
        worst["mean_max_abs"] = max(worst["mean_max_abs"], float((mean - rm).abs().max()))
        worst["scale_ulps"] = max(worst["scale_ulps"], int(
            (scales.view(torch.int32) - rs.view(torch.int32)).abs().max()))
        own = flash._block_quantize(x.float() - mean[:, :, None, :], qb)[1]
        worst["codes_off"] = max(worst["codes_off"], float((diff > 0).float().mean()))
        worst["max_abs_err"] = max(worst["max_abs_err"], int(diff.max()))
        if not (torch.allclose(mean, rm, rtol=1e-6, atol=1e-7) and torch.equal(scales, own)
                and worst["max_abs_err"] <= 1 and worst["codes_off"] <= 1e-3
                and not pad.any()):
            raise SystemExit(f"flash_quant disagrees with the plain prepass ({which}) at S={s}: "
                             f"{worst}, scales equal to the plain quantizer's on its own mean "
                             f"{torch.equal(scales, own)}, padding zero {not pad.any()}")
    row.update(worst)
    # the kernel alone on the wrapper's outputs, then the wrapper (checks and
    # allocations included)
    ptrs = [t.data_ptr() for t in (k, *got[0], v, *got[1])]
    row["ms"] = cuda_ms(lambda i: _cuda.launch("flash_quant", *ptrs, b, h, s, qb,
                                               device=k.device), 1)
    row["wrapper_ms"] = cuda_ms(lambda i: flash.quantize_kv(k, v, qb), 1)
    row["plain_ms"] = cuda_ms(lambda i: plain(), 1)
    row["library_ms"] = None
    skv_p = -(-s // qb) * qb
    nbytes = 2 * (b * h * s * d * 2 + b * h * skv_p * d + b * h * (skv_p // qb) * 4 + b * h * d * 4)
    row["bound_ms"], row["bound_by"] = bound(0.0, PEAK_F32_FLOPS, nbytes)
    return row


def check_flash_lse(s_q: int, gen, entry: str):
    """K14's ``entry`` (the output and per-row log-sum-exp of K3 or of an
    int8 mode) against its plain version at B1 H24 S ``s_q``: the output
    within K3's / the int8 modes' band, the lse within LSE_TOL. ``ms`` times
    the kernel alone (the int8 prepass ran once); for the int8 entries
    ``with_prepass_ms`` times the wrapper and ``design_bound_ms`` is
    check_flash_int8's; library: PyTorch's flash attention with its
    logsumexp, bf16 (for the int8 entries a different function)."""
    import torch

    from diffusion_rs_tpu_torch.ops import _cuda, flash

    s8, s8_pv = LSE_ENTRIES[entry]
    b, h, d = 1, 24, 128
    q, k, v = (torch.randn((b, h, s_q, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if s8 or s8_pv:
        y = flash.flash_int8(q, k, v, scale, s8, s8_pv, lse=lse)
        torch.cuda.synchronize()
        ref, lse_ref, _ = flash.flash_int8_lse_plain(q, k, v, scale, s8, s8_pv)

        def plain():
            return flash.flash_int8_lse_plain(q, k, v, scale, s8, s8_pv)
    else:
        y = flash.flash_fwd(q, k, v, scale, lse=lse)
        torch.cuda.synchronize()
        ref, lse_ref = flash.flash_attention_lse_plain(q, k, v, scale)

        def plain():
            return flash.flash_attention_lse_plain(q, k, v, scale)
    ref = ref.transpose(1, 2).reshape(b, s_q, h * d)
    err = summed_rel(y, ref)
    max_abs = float((y.float() - ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    tol = INT8_TOL if s8 or s8_pv else K3_TOL
    if not (err <= tol and lse_err <= LSE_TOL) or not torch.isfinite(y).all():
        raise SystemExit(f"{entry} disagrees with its plain version at S={s_q}: summed-rel "
                         f"{err:.3e} (band {tol:g}), lse max-abs {lse_err:.3e} (band {LSE_TOL:g})")
    out, lse_out = torch.empty_like(y), torch.empty_like(lse)
    if s8 or s8_pv:
        keep, args = int8_launch_args(q, k, v, scale, s8, s8_pv, out, lse_out)
    else:
        keep, args = (), (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          lse_out.data_ptr(), b, h, s_q, s_q, float(scale))
    row = dict(shape=f"B{b} H{h} S{s_q} D{d}", summed_rel=err, max_abs_err=max_abs,
               lse_max_abs=lse_err)
    row["ms"] = cuda_ms(lambda i: _cuda.launch(entry, *args, device=q.device), 1)
    if not (torch.equal(out, y) and torch.equal(lse_out, lse)):
        raise SystemExit(f"{entry} on pre-quantized inputs differs from its wrapper")
    del keep
    if s8 or s8_pv:
        row["with_prepass_ms"] = cuda_ms(
            lambda i: flash.flash_int8(q, k, v, scale, s8, s8_pv, lse=lse), 1)
        row["design_bound_ms"] = attention_bound(b, h, s_q, d, s8, s8_pv, lse=True,
                                                 design=True)[0]
    row["plain_ms"] = cuda_ms(lambda i: plain(), 1, iters=2, warmup=1)
    row["library_ms"] = cuda_ms(lambda i: torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, False, False, scale=scale), 1)
    if s8 or s8_pv:
        row["library_note"] = "bf16 _scaled_dot_product_flash_attention, a different function"
    row["bound_ms"], row["bound_by"] = attention_bound(b, h, s_q, d, s8, s8_pv, lse=True)
    return row


def check_grouped(kind: str, gen):
    """K8 / K11 at the grouped double-block shapes (img M 4096 + txt M 512):
    each group equal to its own K1 (q8t), K4 (q8_0, q4_0) or K2 (nf4) launch
    bit for bit, and within the K1/K4/K2 band of the plain version; timed at
    the mlp-in shape, with weights rotated through >100 MB of copies."""
    import torch

    from diffusion_rs_tpu_torch.ops import qmatmul
    from diffusion_rs_tpu_torch.quant import dequantize
    from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

    s8 = kind == "q8t"
    plan, grouped, single = {
        "q8t": ("s8", qmatmul.qmm_grouped_s8, qmatmul.qmm_s8),
        "nf4": ("codebook", qmatmul.qmm_grouped_nf4, qmatmul.qmm_nf4),
    }.get(kind, ("affine", qmatmul.qmm_grouped_affine, qmatmul.qmm_affine))
    bf16 = torch.bfloat16

    def weights(k, n):
        qts = [random_qtensor(gen, k, n, kind=kind, device="cuda") for _ in GROUPED_MS]
        for qt in qts:  # scales that differ (q8t per tile and column, nf4 per group)
            if s8:
                qt.scale.uniform_(0.5e-3, 2e-3, generator=gen)
            elif kind == "nf4":
                qt.scale.uniform_(0.01, 0.03, generator=gen)
        return qts

    rows = []
    for k, n in GROUPED_SHAPES:
        qts = weights(k, n)
        xs = [torch.randn((m, k), generator=gen, device="cuda").to(bf16) for m in GROUPED_MS]
        if qmatmul.grouped_plan(qts) != plan:
            raise SystemExit(f"{kind} grouped plan {qmatmul.grouped_plan(qts)}")
        ys = grouped(xs, qts, bf16)
        torch.cuda.synchronize()
        vs_single = max(float((y.float() - single(x, qt, bf16).float()).abs().max())
                        for x, qt, y in zip(xs, qts, ys))
        refs = qmatmul.qmm_grouped_plain(xs, qts, bf16)
        err = summed_rel(torch.cat(ys), torch.cat(refs))
        max_abs = max(float((y.float() - r.float()).abs().max()) for y, r in zip(ys, refs))
        row = dict(shape=f"M{'+'.join(map(str, GROUPED_MS))} K{k} N{n} {kind}",
                   summed_rel=err, max_abs_err=max_abs, vs_single_max_abs=vs_single)
        if vs_single != 0.0:
            raise SystemExit(f"grouped {kind} at K={k} N={n} differs from its per-group "
                             f"launches: max-abs {vs_single:.3e}")
        tol = {"s8": K1_TOL, "codebook": K2_TOL}.get(
            plan, K4_TOL if k <= 3072 else K4_TOL_LONG_K)
        ok = err <= tol and all(torch.isfinite(y).all() for y in ys)
        if plan == "affine":
            ok = ok and all(within_summation_order(y, r, x, qt)
                            for x, qt, y, r in zip(xs, qts, ys, refs))
        if not ok:
            raise SystemExit(f"grouped {kind} disagrees with its plain version at K={k} "
                             f"N={n}: summed-rel {err:.3e} (band {tol:g}), max-abs "
                             f"{max_abs:.3e}")
        if (k, n) == GROUPED_TIMED:
            set_bytes = {"q8t": k * n * (1 + 4 / 256), "q8_0": k * n * (1 + 4 / 32),
                         "q4_0": k * n * (0.5 + 8 / 32), "nf4": k * n * (0.5 + 4 / 64)}[kind]
            n_sets = max(2, math.ceil(100e6 / (2 * set_bytes)))
            sets = [qts] + [weights(k, n) for _ in range(n_sets - 1)]
            deq = [[dequantize(qt, bf16) for qt in ws] for ws in sets]
            row["ms"] = cuda_ms(lambda i: grouped(xs, sets[i], bf16), n_sets)
            row["per_group_ms"] = cuda_ms(  # K1 / K4 / K2
                lambda i: [single(x, qt, bf16) for x, qt in zip(xs, sets[i])], n_sets)
            row["plain_ms"] = cuda_ms(lambda i: qmatmul.qmm_grouped_plain(xs, sets[i], bf16),
                                      n_sets, iters=2, warmup=1)
            row["library_ms"] = cuda_ms(  # two calls: one torch.matmul per group
                lambda i: [torch.matmul(x, w) for x, w in zip(xs, deq[i])], n_sets)
            m_tot = sum(GROUPED_MS)
            nbytes = m_tot * k * 2 + 2 * set_bytes + m_tot * n * 2
            row["bound_ms"], row["bound_by"] = bound(
                2.0 * m_tot * k * n, PEAK_INT8_OPS if s8 else PEAK_BF16_FLOPS, nbytes)
            del sets, deq
        rows.append(row)
    return rows


def tiny_configs():
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig

    return dict(
        flux_cfg=FluxConfig(in_channels=64, pooled_projection_dim=64,
                            joint_attention_dim=256, num_attention_heads=2,
                            num_layers=1, num_single_layers=2, hidden_size=256,
                            axes_dim=(16, 56, 56)),
        t5_cfg=T5Config(vocab_size=512, d_model=256, d_kv=64, d_ff=512,
                        num_layers=2, num_heads=4),
        clip_cfg=ClipTextConfig(vocab_size=512, projection_dim=64,
                                intermediate_size=128, num_hidden_layers=2,
                                num_attention_heads=4),
        vae_cfg=VAEConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8),
    )


def make_params(cfgs, seed: int, device: str, flux_kind: str = "q8t") -> dict:
    from diffusion_rs_tpu_torch.util import synthetic as syn

    return dict(
        flux_params=syn.init_flux_params_quantized(seed, cfgs["flux_cfg"], kind=flux_kind,
                                                   device=device),
        t5_params=syn.init_t5_params_quantized(seed + 1, cfgs["t5_cfg"], kind="nf4",
                                               device=device),
        clip_params=syn.init_clip_params(seed + 2, cfgs["clip_cfg"], device=device),
        vae_params={**syn.init_vae_decoder_params(seed + 3, cfgs["vae_cfg"], device=device),
                    **syn.init_vae_encoder_params(seed + 4, cfgs["vae_cfg"], device=device)},
    )


def make_pipeline(cfgs, params: dict, device: str, mesh=None, offload=None):
    """A FluxPipeline on ``params``; under a mesh with tp > 1 the pipeline
    cuts FLUX and T5 to this rank's slices."""
    import torch

    from diffusion_rs_tpu_torch import FluxPipeline
    from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig
    from diffusion_rs_tpu_torch.util.synthetic import WordTokenizer

    return FluxPipeline(
        scheduler=SchedulerConfig(use_dynamic_shifting=True),
        t5_tokenizer=WordTokenizer(cfgs["t5_cfg"].vocab_size),
        clip_tokenizer=WordTokenizer(cfgs["clip_cfg"].vocab_size),
        dtype=torch.bfloat16, device=device, mesh=mesh, offload=offload, **cfgs, **params,
    )


def tiny_inputs(pipe):
    """The tiny card-vs-CPU images' inputs: token ids of one prompt, the
    noise of a CPU generator, a 2-step schedule."""
    import torch

    from diffusion_rs_tpu_torch.io.tokenizer import tokenize_and_pad

    prompts = ["a photo of a small cat"]
    t5_ids = torch.from_numpy(tokenize_and_pad(prompts, pipe.t5_tokenizer, pad_to=512))
    clip_ids = torch.from_numpy(tokenize_and_pad(prompts, pipe.clip_tokenizer))
    noise = torch.randn((1, 16, 8, 8), generator=torch.Generator().manual_seed(5))
    return t5_ids, clip_ids, noise, pipe.scheduler.timesteps(2, mu=0.6)


def tiny_image(pipe, inputs, dev: str):
    """encode, denoise (gathered over sp under a mesh), decode: the latent
    [1, 16, 64] and the u8 image on the host."""
    import torch

    from diffusion_rs_tpu_torch.parallel.mesh import Sharding

    t5_ids, clip_ids, noise, sig = inputs
    txt, y = pipe._encode(t5_ids.to(dev), clip_ids.to(dev))
    g = torch.full((1,), 3.5, device=dev)
    lat = pipe._denoise(txt, y, sig, g, noise.to(dev))
    if pipe.mesh is not None:
        lat = Sharding(pipe.mesh, (None, "sp")).gather(lat, (1, 16, lat.shape[2]))
    return lat.float().cpu(), pipe._decode(lat, 64, 64).cpu().numpy()


def image_match(card, cpu):
    """Latent summed-rel and u8 image PSNR of a card image against the CPU's."""
    import numpy as np

    lat_err = summed_rel(card[0], cpu[0])
    mse = float(np.mean((card[1].astype(np.float64) - cpu[1].astype(np.float64)) ** 2))
    return lat_err, float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def tiny_reference_check(attn_layout=None, flux_kind="q8t", fuse=None, int8=False,
                         isq=False):
    """The port on the card (kernels) against the port on the CPU (plain
    versions), same weights and noise, tiny config at 64x64, 2 steps. With
    ``attn_layout``, both take the loader's layout transform with every
    stream fused and grouped and DIFFUSION_RS_TPU_FUSED_ROPE=1, and attention
    runs in that layout; ``fuse`` alone takes the transform with that fuse=;
    ``flux_kind`` picks FLUX's weight format; ``int8`` sets both int8
    attention knobs; ``isq`` starts from dense FLUX and T5, each device
    quantizes its own copy through the loader's weight options (config E's
    q4_k with an imatrix and a LoRA, tiny_isq_params) and both run with
    DIFFUSION_RS_TPU_QMM_FAST16=1. The card run must launch the path's
    kernels."""
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.pipelines.loader import apply_layout_options
    from diffusion_rs_tpu_torch.util.tree import tree_map

    cfgs = tiny_configs()
    params = make_params(cfgs, seed=11, device="cpu", flux_kind=flux_kind)
    if attn_layout is not None:
        fuse = FUSE_ALL_GROUPED
    if fuse is not None:
        with env(DIFFUSION_RS_TPU_FUSED_ROPE="0" if attn_layout is None else "1"):
            flux, flux_cfg, t5 = apply_layout_options(
                params["flux_params"], cfgs["flux_cfg"], params["t5_params"], fuse=fuse)
        params = {**params, "flux_params": flux, "t5_params": t5}
        cfgs = {**cfgs, "flux_cfg": flux_cfg}
    if isq:
        cpu_params, gpu_params = tiny_isq_params(cfgs, params)
    else:
        cpu_params, gpu_params = params, tree_map(lambda t: t.cuda(), params)
    cpu = make_pipeline(cfgs, cpu_params, device="cpu")
    gpu = make_pipeline(cfgs, gpu_params, device="cuda")
    inputs = tiny_inputs(cpu)
    outs = {}
    layout_env = {} if attn_layout is None else {"DIFFUSION_RS_TPU_ATTN_LAYOUT": attn_layout}
    if isq:
        layout_env["DIFFUSION_RS_TPU_QMM_FAST16"] = "1"
    with env(**layout_env), attention_knobs(int8, int8):
        for name, pipe, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
            _cuda.reset_launch_counts()
            outs[name] = tiny_image(pipe, inputs, dev)
    counts = _cuda.launch_counts()
    lat_err, psnr = image_match(outs["gpu"], outs["cpu"])
    label = ", ".join(
        ([f"FLUX {flux_kind}"] if flux_kind != "q8t" else [])
        + ([f'fuse="{fuse}"'] if fuse else [])
        + ([f"FUSED_ROPE=1, ATTN_LAYOUT={attn_layout}"] if attn_layout else [])
        + (["ATTN_S8=1, ATTN_S8PV=1"] if int8 else [])
        + (['isq="q4_k", imatrix, LoRA, QMM_FAST16=1'] if isq else [])) or "default layout"
    print(f"tiny reference ({label}): latent summed-rel {lat_err:.3e}, image PSNR "
          f"{psnr:.1f} dB (card kernels vs CPU plain versions, bf16); card launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if not (lat_err <= 2e-2 and psnr >= 30.0):
        raise SystemExit("tiny reference check failed: the card's image does not "
                         "agree with the plain versions on the CPU")
    flash_kernel = {"inkernel": "flash_rope", "seqmajor": "flash_sm", None: "flash_fwd"}[
        attn_layout]
    if int8:
        flash_kernel = "flash_s8_s8pv"
    qmm_kernel = {"q8t": "qmm_s8", "nf4": "qmm_nf4"}[flux_kind]
    if fuse is not None and "grouped" in fuse:
        qmm_kernel = {"q8t": "qmm_grouped_s8", "nf4": "qmm_grouped_nf4"}[flux_kind]
    others = [k for k in ("flash_fwd", "flash_sm", "flash_rope", "flash_s8_s8pv")
              if k != flash_kernel] + ([] if int8 else ["flash_quant"])
    if isq:  # every quantized FLUX and T5 linear is q4_k: K13 alone
        qmm_kernel = "qmm_affine_fast16"
        others += ["qmm_s8", "qmm_nf4", "qmm_affine"]
    if not (counts[flash_kernel] > 0 and counts[qmm_kernel] > 0
            and not any(counts[k] for k in others)
            and counts["rope_qk"] == (counts["flash_rope"] if flash_kernel == "flash_rope" else 0)
            and counts == with_prologue(counts)
            and (not int8 or counts["flash_quant"] == counts["flash_s8_s8pv"])):
        raise SystemExit(f"tiny image ({label}) did not run its kernels: {counts}")
    return lat_err, psnr


@contextlib.contextmanager
def fixed_draws(noise, eps):
    """The pipeline's denoise noise and encoder sample replaced by these host
    tensors (moved to the pipeline's device), so a card and a CPU pipeline
    start from the same draws through ``forward_arrays`` itself."""
    from diffusion_rs_tpu_torch.pipelines import flux_pipeline

    real = flux_pipeline.get_noise, flux_pipeline.get_encode_noise
    flux_pipeline.get_noise = lambda seed, n, h, w, device: noise.to(device)
    flux_pipeline.get_encode_noise = lambda seed, shape, dtype, device: eps.to(device, dtype)
    try:
        yield
    finally:
        flux_pipeline.get_noise, flux_pipeline.get_encode_noise = real


def tiny_edit_check(mode: str):
    """img2img (strength 0.5) or inpaint (0.75, a centre square at the latent
    size) through ``FluxPipeline.forward_arrays`` on the tiny config, 4 steps
    at 64x64: the card's kernels against the plain versions on the CPU, same
    weights, init image, noise and encoder sample. The card run must launch
    K1, K2 and K3 and no other kernel."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.util.tree import tree_map

    cfgs = tiny_configs()
    params = make_params(cfgs, seed=11, device="cpu")
    cpu = make_pipeline(cfgs, params, device="cpu")
    gpu = make_pipeline(cfgs, tree_map(lambda t: t.cuda(), params), device="cuda")
    gen = torch.Generator().manual_seed(6)
    init = (torch.rand((64, 64, 3), generator=gen) * 255).to(torch.uint8).numpy()
    noise = torch.randn((1, 16, 8, 8), generator=gen)
    eps = torch.randn((1, 8, 8, 16), generator=gen)
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 2:6] = 255
    extra = dict(strength=0.5) if mode == "img2img" else dict(strength=0.75, mask_image=mask)
    gp = DiffusionGenerationParams(height=64, width=64, num_steps=4, guidance_scale=3.5, seed=5)
    outs = {}
    with fixed_draws(noise, eps):
        for name, pipe in (("cpu", cpu), ("gpu", gpu)):
            captured = {}
            denoise_stage = pipe._denoise

            def capture(*a, _stage=denoise_stage, _into=captured):
                _into["latent"] = _stage(*a)
                return _into["latent"]

            pipe._denoise = capture
            _cuda.reset_launch_counts()
            img = pipe.forward_arrays(["a photo of a small cat"], gp, init_image=init, **extra)
            outs[name] = (captured["latent"].float().cpu(), img[0])
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    lat_err, psnr = image_match(outs["gpu"], outs["cpu"])
    print(f"tiny reference ({mode}): latent summed-rel {lat_err:.3e}, image PSNR {psnr:.1f} dB "
          f"(card kernels vs CPU plain versions, bf16); card launches {counts}")
    if not (lat_err <= 2e-2 and psnr >= 30.0):
        raise SystemExit(f"tiny {mode} check failed: the card's image does not agree with "
                         "the plain versions on the CPU")
    if (sorted(counts) != ["flash_fwd", "qk_norm_rope", "qmm_nf4", "qmm_s8"]
            or counts != with_prologue(counts)):
        raise SystemExit(f"tiny {mode} image did not run K1, K2, K3 and the prologue alone: "
                         f"{counts}")


def flux_linear_names(params) -> dict:
    """Dotted name -> K of every FLUX linear, per layer for stacked blocks
    (``double.3.img_attn.q``): the names quant/isq.isq_tree looks up."""
    from diffusion_rs_tpu_torch.ops.linear import Linear

    out = {}

    def walk(node, names):
        if isinstance(node, Linear):
            k = node.w.shape[-2]
            if node.w.dim() == 3:
                for i in range(node.w.shape[0]):
                    out[".".join(names[:1] + [str(i)] + names[1:])] = k
            else:
                out[".".join(names)] = k
        elif isinstance(node, dict):
            for key, v in node.items():
                walk(v, names + [key])

    walk(params, [])
    return out


def write_flux_imatrix(path, params, seed: int) -> dict:
    """A seeded imatrix file covering every FLUX linear (positive log-normal
    importances), written with the port's save_imatrix and read back with
    load_imatrix; returns what load_imatrix read."""
    import numpy as np

    from diffusion_rs_tpu_torch.io.imatrix import load_imatrix, save_imatrix

    rng = np.random.default_rng(seed)
    data = {name: np.exp(rng.standard_normal(k)).astype(np.float32)
            for name, k in flux_linear_names(params).items()}
    save_imatrix(str(path), data, ncall=8)
    back = load_imatrix(str(path))
    if sorted(back) != sorted(data):
        raise SystemExit("the imatrix file did not read back its names")
    return back


def write_flux_lora(path, cfg, seed: int, rank: int = 16) -> int:
    """A seeded rank-``rank`` diffusers-PEFT LoRA written with the port's
    safetensors writer: to_q / to_k / to_v of every block and to_out.0 of the
    double blocks (single blocks have no to_out), alpha = rank. Returns the
    number of factor pairs."""
    import numpy as np

    from diffusion_rs_tpu_torch.io.safetensors import save_safetensors

    rng = np.random.default_rng(seed)
    h = cfg.hidden_size
    bases = [f"transformer_blocks.{i}.attn.{p}" for i in range(cfg.num_layers)
             for p in ("to_q", "to_k", "to_v", "to_out.0")]
    bases += [f"single_transformer_blocks.{i}.attn.{p}" for i in range(cfg.num_single_layers)
              for p in ("to_q", "to_k", "to_v")]
    t = {}
    for base in bases:
        t[f"transformer.{base}.lora_A.weight"] = (
            rng.standard_normal((rank, h)) * h ** -0.5).astype(np.float32)
        t[f"transformer.{base}.lora_B.weight"] = (
            rng.standard_normal((h, rank)) * 0.01).astype(np.float32)
        t[f"transformer.{base}.alpha"] = np.float32(rank)
    save_safetensors(str(path), t)
    return len(bases)


ISQ_TARGET = "q4_k"


def tiny_isq_params(cfgs, params):
    """Dense tiny FLUX and T5 (the preset's factories) with CLIP and the VAE
    of ``params``, through the loader's weight options on each device: the
    CPU copy quantized on the CPU, the card's copy on the card (q4_k, a
    seeded imatrix over every FLUX linear, a rank-4 LoRA;
    DIFFUSION_RS_TPU_ISQ_MIN=64 for the tiny widths). Every plane must be
    equal on both: the imatrix group sums run term by term in one order on
    either device. Returns (CPU params, card params)."""
    import tempfile

    import torch

    from diffusion_rs_tpu_torch.pipelines.loader import apply_weight_options
    from diffusion_rs_tpu_torch.quant import QuantizedTensor
    from diffusion_rs_tpu_torch.util import synthetic as syn
    from diffusion_rs_tpu_torch.util.tree import tree_map

    dense = {**params, "flux_params": syn.init_flux_params(21, cfgs["flux_cfg"], device="cpu"),
             "t5_params": syn.init_t5_params(22, cfgs["t5_cfg"], device="cpu")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp, env(DIFFUSION_RS_TPU_ISQ_MIN="64"):
        write_flux_imatrix(f"{tmp}/imatrix.dat", dense["flux_params"], seed=23)
        write_flux_lora(f"{tmp}/lora.safetensors", cfgs["flux_cfg"], seed=24, rank=4)
        for dev in ("cpu", "cuda"):
            p = dense if dev == "cpu" else tree_map(lambda t: t.cuda(), dense)
            flux, t5 = apply_weight_options(
                p["flux_params"], cfgs["flux_cfg"], p["t5_params"], isq=ISQ_TARGET,
                imatrix=f"{tmp}/imatrix.dat", lora=f"{tmp}/lora.safetensors")
            out[dev] = {**p, "flux_params": flux, "t5_params": t5}
    planes = differ = 0
    for tree in ("flux_params", "t5_params"):
        a = [x for x in _walk_qts(out["cpu"][tree])]
        b = [x for x in _walk_qts(out["cuda"][tree])]
        for qa, qb in zip(a, b):
            for f in ("packed", "scale", "bias"):
                planes += 1
                differ += not torch.equal(getattr(qa, f), getattr(qb, f).cpu())
        if len(a) != len(b) or not a or not all(isinstance(q, QuantizedTensor) for q in b):
            raise SystemExit("tiny ISQ quantized different linears on the card and the CPU")
    line = (f"tiny ISQ ({ISQ_TARGET}, imatrix, LoRA) on the card and on the CPU: {differ} of "
            f"{planes} planes differ")
    if differ:
        raise SystemExit(line)
    print(line)
    return out["cpu"], out["cuda"]


def _walk_qts(tree):
    """QuantizedTensors of a tree's Linears, in a fixed order."""
    from diffusion_rs_tpu_torch.ops.linear import Linear
    from diffusion_rs_tpu_torch.quant import QuantizedTensor

    if isinstance(tree, Linear):
        if isinstance(tree.w, QuantizedTensor):
            yield tree.w
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk_qts(tree[key])


def profile_image(pipe, prompts) -> None:
    """Trace one 1-step image with torch.profiler: device time by kernel
    name (top 20) and the device's busy share of the traced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_rs_tpu_torch import DiffusionGenerationParams

    params = DiffusionGenerationParams(height=1024, width=1024, num_steps=1,
                                       guidance_scale=3.5, seed=7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.forward_arrays(prompts, params)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): operator rows would count
    # their kernels' time a second time
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    print(f"profile (1-step image): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), timings {pipe.timings}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f}%  x{n:<5d} {key[:90]}")


# The serve phase's eight requests: (prompt, seed, img2img), in two bursts of
# four; the second burst repeats two prompts of the first, so the encode
# cache hits, and each burst's last request is an img2img lane.
SERVE_REQUESTS = (
    ("a photo of a cat sitting on a wooden table", 11, False),
    ("a red house by the sea at dusk", 12, False),
    ("a bowl of ripe oranges on a blue cloth", 13, False),
    ("an old lighthouse in the fog", 14, True),
    ("a map of a harbour drawn in ink", 15, False),
    ("a photo of a cat sitting on a wooden table", 16, False),
    ("a red house by the sea at dusk", 17, False),
    ("a snowy mountain village at night", 18, True),
)
SERVE_STRENGTH = 0.6
SERVE_MAX_BATCH = 4
# each lane against the port's offline image at the same seed: the JAX
# server's own band against its offline pipeline (tests/test_serving.py)
SERVE_MEAN_BAND, SERVE_MAX_BAND = 1.0, 16


def serve_phase(pipe, steps: int, init_img) -> list:
    """Phase 4e, the continuous-batching server (serving.FluxServer,
    ``max_batch`` 4) on phase 4's resident q8t pipeline: K1 at the batched
    shapes (M 16384 / 2048 / 18432) and K3 at B4 S4608 against their plain
    versions, then SERVE_REQUESTS one by one through ``forward_arrays`` (the
    offline images at batch 1, timed: the sequential baseline), a 1-step
    warm-up of the 4-lane bucket, and the eight requests through the server
    in two bursts (the second once the first lanes have run 2 steps), each
    lane's image against its offline image. Fails unless every lane is in
    the band, ``stats()`` reads 8 completed, 0 failed, the lanes' steps and
    at least 2 encode-cache hits, K1 and K3 ran a batch-1 step's count per
    forward and K2 168 per encode. Returns the timed kernel rows."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda, flash, qmatmul
    from diffusion_rs_tpu_torch.serving import FluxServer

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = [check_qmm("q8t", m, 3072, 3072, gen, K1_TOL, detail=False)
            for m in (16384, 2048, 18432)]
    rows.append(check_flash(4608, gen, b=SERVE_MAX_BATCH))
    for r in rows:
        lib = f"{r['library_ms']:.4f} ms"
        print(f"serve kernel {'qmm_s8' if r['shape'].startswith('M') else 'flash_fwd'} "
              f"{r['shape']}: summed-rel {r['summed_rel']:.3e} max-abs {r['max_abs_err']:.3e} "
              f"| kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}")
    gc.collect()

    def params(seed, num_steps=steps):
        return DiffusionGenerationParams(height=1024, width=1024, num_steps=num_steps,
                                         guidance_scale=3.5, seed=seed)

    i2i = dict(init_image=init_img, strength=SERVE_STRENGTH)
    pipe.forward_arrays([SERVE_REQUESTS[3][0]], params(0, 1), **i2i)  # the i2i path warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    offline = [pipe.forward_arrays([p], params(seed), **(i2i if edit else {}))[0]
               for p, seed, edit in SERVE_REQUESTS]
    seq_s = time.perf_counter() - t0

    # one forward of the 4-lane bucket before the timed run (a long poll: the
    # four lanes join one tick)
    warm = FluxServer(pipe, max_batch=SERVE_MAX_BATCH, poll_ms=1000.0, encode_cache=0)
    try:
        [f.result() for f in [warm.submit(p, params(seed, 1))
                              for p, seed, _ in SERVE_REQUESTS[:SERVE_MAX_BATCH]]]
    finally:
        warm.shutdown()
    # the timed run tallies K1's launches by M and K3's by B (a Python call
    # around each wrapper)
    shapes = {"qmm_s8": collections.Counter(), "flash_fwd": collections.Counter()}
    k1, k3 = qmatmul.qmm_s8, flash.flash_fwd

    def k1_tally(x2, qt, out_dtype):
        shapes["qmm_s8"][f"M{x2.shape[0]}"] += 1
        return k1(x2, qt, out_dtype)

    def k3_tally(q, *a, **kw):
        shapes["flash_fwd"][f"B{q.shape[0]}"] += 1
        return k3(q, *a, **kw)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server = FluxServer(pipe, max_batch=SERVE_MAX_BATCH)
    _cuda.reset_launch_counts()
    qmatmul.qmm_s8, flash.flash_fwd = k1_tally, k3_tally
    try:
        t0 = time.perf_counter()

        def submit(reqs):
            return [server.submit(p, params(seed), **(i2i if edit else {}))
                    for p, seed, edit in reqs]

        futs = submit(SERVE_REQUESTS[:4])
        while server.stats()["forwards"] < 2:  # the first lanes at step 2
            time.sleep(0.002)
        futs += submit(SERVE_REQUESTS[4:])
        served = [f.result(timeout=600) for f in futs]
        srv_s = time.perf_counter() - t0
    finally:
        qmatmul.qmm_s8, flash.flash_fwd = k1, k3
        server.shutdown()
    counts = _cuda.launch_counts()
    stats = server.stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    bands = []
    for (p, seed, edit), got, want in zip(SERVE_REQUESTS, served, offline):
        d = np.abs(got.astype(np.float32) - want.astype(np.float32))
        bands.append((float(d.mean()), float(d.max())))
    lane_steps = sum(max(1, round(steps * SERVE_STRENGTH)) if edit else steps
                     for _, _, edit in SERVE_REQUESTS)
    encodes = len(SERVE_REQUESTS) - stats["encode_cache_hits"]
    want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), "qmm_s8": 503 * stats["forwards"],
                          "flash_fwd": 57 * stats["forwards"], "qmm_nf4": 168 * encodes})
    n = len(SERVE_REQUESTS)
    print(f"serve: {n} requests ({sum(e for *_, e in SERVE_REQUESTS)} img2img at "
          f"{SERVE_STRENGTH}), {steps} steps, 1024x1024, max_batch {SERVE_MAX_BATCH}: "
          f"served {n / srv_s:.4f} images/s ({srv_s:.3f} s) against {n / seq_s:.4f} images/s "
          f"one by one offline ({seq_s:.3f} s), {seq_s / srv_s:.3f}x")
    print(f"serve stats {json.dumps(stats)}")
    print(f"serve: {stats['forwards']} forwards for {stats['lane_steps']} lane steps "
          f"(+{stats['padded_lane_steps']} padded), occupancy {stats['occupancy']:.4f}; peak "
          f"memory {peak:.2f} GiB ({capacity_estimate(pipe, SERVE_MAX_BATCH)})")
    print("serve lanes vs the offline images (u8 mean |diff|, max): "
          + ", ".join(f"{m:.4f} / {x:.0f}" for m, x in bands))
    print(f"serve launches { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }); by shape "
          + json.dumps({k: dict(sorted(v.items())) for k, v in shapes.items()}))
    bad = [i for i, (m, x) in enumerate(bands) if not (m < SERVE_MEAN_BAND and x <= SERVE_MAX_BAND)]
    if bad or any(o.shape != (1024, 1024, 3) for o in served):
        raise SystemExit(f"serve lanes {bad} outside the band of their offline images: {bands}")
    if not (stats["completed"] == n and stats["failed"] == 0
            and stats["lane_steps"] == lane_steps and stats["encode_cache_hits"] >= 2):
        raise SystemExit(f"serve stats {stats}: expected {n} completed, 0 failed, "
                         f"{lane_steps} lane steps, >= 2 encode-cache hits")
    if counts != want:
        raise SystemExit(f"serve launch counts {counts} differ from {want}")
    return rows


def small_entry_points() -> None:
    """The other entry points at a tiny size on the card: ``serve_http`` on
    localhost (one ``POST /generate``, one ``GET /metrics``), and one 1-step
    img2img image under DIFFUSION_RS_TPU_TRACE_DIR, whose trace must name
    the pipeline's five spans and K1's kernel."""
    import tempfile
    import urllib.request

    import numpy as np

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.serving import FluxServer, serve_http

    cfgs = tiny_configs()
    pipe = make_pipeline(cfgs, make_params(cfgs, seed=21, device="cuda"), device="cuda")
    server = FluxServer(pipe, max_batch=SERVE_MAX_BATCH)
    httpd = serve_http(server, "127.0.0.1", 0, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = json.dumps({"prompt": "a photo of a small cat", "height": 64, "width": 64,
                           "num_steps": 2, "seed": 3}).encode()
        req = urllib.request.Request(base + "/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            png, ctype = r.read(), r.headers["Content-Type"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
    size = tuple(int.from_bytes(png[i:i + 4], "big") for i in (16, 20))
    print(f"serve_http: POST /generate -> {ctype}, {len(png)} bytes, {size[0]}x{size[1]}; "
          f"GET /metrics -> {len(metrics.splitlines())} lines")
    if not (png[:8] == b"\x89PNG\r\n\x1a\n" and size == (64, 64) and ctype == "image/png"
            and "drs_server_completed_total 1" in metrics):
        raise SystemExit("serve_http did not answer with a 64x64 PNG and the metrics")

    spans = ("generate", "text-encode", "vae-encode", "denoise", "vae-decode")
    params = DiffusionGenerationParams(height=64, width=64, num_steps=1, guidance_scale=3.5,
                                       seed=5)
    init = np.random.default_rng(5).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp, env(DIFFUSION_RS_TPU_TRACE_DIR=tmp):
        pipe.forward_arrays(["a photo of a small cat"], params, init_image=init, strength=1.0)
        files = os.listdir(tmp)
        names = set()
        if len(files) == 1:
            with open(os.path.join(tmp, files[0])) as f:
                names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = [sp for sp in spans if sp in names]
    k1 = sorted({n for n in names if "qmm_s8_kernel" in n})
    print(f"trace (DIFFUSION_RS_TPU_TRACE_DIR, 1-step img2img): files {files}, spans {found}, "
          f"K1 kernels {k1}")
    if len(found) != len(spans) or not k1:
        raise SystemExit(f"the trace names spans {found} and K1 kernels {k1}")


def image_edit_phase(pipe, prompts, steps: int, init_img, ref_latent) -> None:
    """Phase 4b, on phase 4's q8t pipeline and its 1024x1024 image as the init
    image: a 1-step warm-up, then img2img at strength 0.6 (``round(0.6 *
    steps)`` steps run), inpaint at strength 1.0 with a centre-square mask
    (at 1024x1024 through PIL's BILINEAR where Pillow is installed, else
    at the 128x128 latent size), and img2img at strength 1.0, each through
    ``forward_arrays`` with exact K1 / K2 / K3 launch counts (reset just
    before each image, read just after). Fails unless the inpaint's final
    latent equals the packed init latent wherever the mask is 0, and the
    strength-1.0 latent equals phase 4's (``ref_latent``, same seed)."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda

    n = flux_launches(pipe.flux_cfg)
    captured = {}
    denoise_stage = pipe._denoise

    def capture_denoise(txt, y, sigmas, guidance, noise, inpaint=None):
        captured["inpaint"] = inpaint
        captured["latent"] = denoise_stage(txt, y, sigmas, guidance, noise, inpaint)
        return captured["latent"]

    pipe._denoise = capture_denoise
    try:
        import PIL  # noqa: F401

        mask = np.zeros((1024, 1024), np.uint8)
        mask[256:768, 256:768] = 255
        mask_note = "1024x1024 mask through PIL"
    except ImportError:
        mask = np.zeros((128, 128), np.uint8)
        mask[32:96, 32:96] = 255
        mask_note = "no Pillow on this host: 128x128 mask at the latent size"

    def params(num_steps):
        return DiffusionGenerationParams(height=1024, width=1024, num_steps=num_steps,
                                         guidance_scale=3.5, seed=7)

    t0 = time.perf_counter()
    pipe.forward_arrays(prompts, params(1), init_image=init_img, strength=1.0)
    print(f"img2img warm-up (1 step) in {time.perf_counter() - t0:.1f} s")
    results = {}
    for name, strength, m in (("img2img 0.6", 0.6, None), ("inpaint 1.0", 1.0, mask),
                              ("img2img 1.0", 1.0, None)):
        run = max(1, min(int(round(steps * strength)), steps))
        want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), "qmm_s8": n["diffusers"] * run,
                              "qmm_nf4": 168, "flash_fwd": n["attention"] * run})
        torch.cuda.reset_peak_memory_stats()
        before = card_state()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        img = pipe.forward_arrays(prompts, params(steps), init_image=init_img,
                                  strength=strength, mask_image=m)
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        tm = pipe.timings
        steps_ms = [x * 1e3 for x in tm["steps_s"]]
        print(f"{name}{' (' + mask_note + ')' if m is not None else ''}: {run} of {steps} "
              f"steps, image {wall:.3f} s: text encode {tm['encode_s'] * 1e3:.1f} ms, image "
              f"encode {tm['image_encode_s'] * 1e3:.1f} ms, step median "
              f"{statistics.median(steps_ms):.2f} ms ({min(steps_ms):.1f}-{max(steps_ms):.1f}), "
              f"decode {tm['decode_s'] * 1e3:.1f} ms, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card before: {before}; "
              f"after: {card_state()}")
        print(f"{name} launches { {k: v for k, v in counts.items() if v} } (expected "
              f"{ {k: v for k, v in want.items() if v} }, every other kernel 0)")
        lat = captured["latent"]
        if counts != want:
            raise SystemExit(f"{name} launch counts {counts} differ from its path's {want}")
        if img.shape != (1, 1024, 1024, 3) or img.dtype.name != "uint8":
            raise SystemExit(f"bad {name} image: {img.dtype} {img.shape}")
        if tuple(lat.shape) != (1, 4096, 64) or not torch.isfinite(lat).all():
            raise SystemExit(f"bad {name} latent: {tuple(lat.shape)}")
        results[name] = (lat, captured["inpaint"])
    pipe._denoise = denoise_stage

    lat, (mask_plane, init_plane, _) = results["inpaint 1.0"]
    keep = mask_plane == 0
    pinned = bool(torch.equal(lat[keep], init_plane[keep]))
    moved = summed_rel(lat[~keep], init_plane[~keep])
    print(f"inpaint: {int(keep.sum())} of {keep.numel()} latent entries unmasked, equal to the "
          f"packed init latent: {pinned}; masked entries {moved:.3e} (summed-rel) from it")
    if not (pinned and keep.any() and (~keep).any() and moved > 1e-2):
        raise SystemExit("inpaint: the unmasked latent is not the init latent, or the mask "
                         "repainted nothing")
    lat = results["img2img 1.0"][0]
    same = bool(torch.equal(lat, ref_latent))
    print(f"img2img at strength 1.0 vs phase 4's latent (same seed): equal {same}, "
          f"summed-rel {summed_rel(lat, ref_latent):.3e}")
    if not same:
        raise SystemExit("img2img at strength 1.0 does not reproduce the txt2img latent")


def host_memory() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(rest.split()[0]) * 1024
    return out


def process_rss() -> int:
    """This process's resident host memory (VmRSS of /proc/self/status), in
    bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise SystemExit("no VmRSS in /proc/self/status")


def require_host_memory(need: int, what: str) -> None:
    """Fail (no skip) when MemAvailable is below ``need`` bytes."""
    avail = host_memory()["MemAvailable"]
    print(f"{what}: needs up to {need / 2**30:.2f} GiB of host memory, MemAvailable "
          f"{avail / 2**30:.2f} GiB")
    if avail < need:
        raise SystemExit(f"{what} needs {need / 2**30:.2f} GiB of host memory; MemAvailable "
                         f"is {avail / 2**30:.2f} GiB")


def full_offload_phase(cfgs, pipe, prompts, steps: int, want: dict, ref: dict) -> None:
    """Phase 4c, Offloading.Full on phase 4's weights: the four components
    registered in a HostOffload (pinned host copies; phase 4's device
    weights stay allocated beside them), then one ``steps``-step 1024x1024
    image through ``forward_arrays`` with each component on the card only
    around its stage. Fails unless the latent equals phase 4's (``ref``)
    bit for bit and the launch counts are phase 4's. Then per component its
    bytes, the time of its ``resident`` copy, and the allocated bytes before
    and after ``release``, which must fall by at least the component's
    bytes."""
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.parallel import HostOffload
    from diffusion_rs_tpu_torch.util.capacity import tree_device_bytes

    names = ("t5", "clip", "vae", "flux")
    comps = {n: getattr(pipe, f"{n}_params") for n in names}
    sizes = {n: tree_device_bytes(p) for n, p in comps.items()}
    # the pinned buffers take the components' bytes (exact size, 128-byte
    # leaf offsets); a quarter more leaves the process room
    require_host_memory(sum(sizes.values()) * 5 // 4, "phase 4c (Offloading.Full)")
    off = HostOffload()
    torch.cuda.synchronize()
    avail, rss = host_memory()["MemAvailable"], process_rss()
    t0 = time.perf_counter()
    opipe = make_pipeline(cfgs, {f"{n}_params": p for n, p in comps.items()}, "cuda",
                          offload=off)
    pin_s = time.perf_counter() - t0
    print(f"phase 4c: registered {sum(sizes.values()) / 2**30:.3f} GiB into pinned host "
          f"memory in {pin_s:.2f} s (" + ", ".join(f"{n} {sizes[n] / 2**30:.3f} GiB"
                                                    for n in names)
          + f"); the process's VmRSS grew by {(process_rss() - rss) / 2**30:.3f} GiB, "
          f"MemAvailable fell by {(avail - host_memory()['MemAvailable']) / 2**30:.3f} GiB")
    captured = {}
    denoise_stage = opipe._denoise

    def capture_denoise(*a):
        captured["latent"] = denoise_stage(*a)
        return captured["latent"]

    opipe._denoise = capture_denoise
    params = DiffusionGenerationParams(height=1024, width=1024, num_steps=steps,
                                       guidance_scale=3.5, seed=7)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    img = opipe.forward_arrays(prompts, params)
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    tm = opipe.timings
    steps_ms = [x * 1e3 for x in tm["steps_s"]]
    same = bool(torch.equal(captured["latent"], ref["latent"]))
    print(f"phase 4c image {wall:.3f} s: encode {tm['encode_s'] * 1e3:.1f} ms (T5 and CLIP "
          f"copied in), step median {statistics.median(steps_ms):.2f} ms (phase 4 "
          f"{ref['step_ms']:.2f}), denoise {tm['denoise_s'] * 1e3:.1f} ms (FLUX copied in), "
          f"decode {tm['decode_s'] * 1e3:.1f} ms (VAE copied in); peak allocated above the "
          f"phase's start {peak:.2f} GiB (phase 4: peak {ref['peak']:.2f} GiB with "
          f"{ref['weights']:.2f} GiB of weights resident); latent equal to phase 4's: {same}")
    print(f"phase 4c launches { {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise SystemExit(f"phase 4c launch counts {counts} differ from phase 4's {want}")
    if not same or img.shape != (1, 1024, 1024, 3):
        raise SystemExit(f"phase 4c: latent equal {same}, image {img.shape}; "
                         f"{summed_rel(captured['latent'], ref['latent']):.3e} from phase 4's")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for n in names:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        start.record()
        tree = off.resident(n)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        held = torch.cuda.memory_allocated()
        del tree
        off.release(n)
        after = torch.cuda.memory_allocated()
        print(f"phase 4c {n}: {sizes[n]} bytes, resident copy {ms:.2f} ms "
              f"({sizes[n] / ms / 1e6:.2f} GB/s), allocated {before} -> {held} on resident, "
              f"{held} -> {after} on release (fell {held - after} bytes)")
        if held - after < sizes[n]:
            raise SystemExit(f"phase 4c: release of {n} freed {held - after} bytes of "
                             f"{sizes[n]}")


def stream_phase(cfgs, pipe, prompts, steps: int, want: dict, ref: dict) -> None:
    """Phase 4d, Offloading.Stream on phase 4's FLUX weights: a StreamedFlux
    packed block by block from the card into pinned host buffers, in a
    pipeline with phase 4's encoders and VAE; a 1-step warm-up, then the
    ``steps``-step image at lookahead 2 and again at lookahead 1 (two
    slots: where a slot-reuse race would show). Fails unless each latent
    equals phase 4's bit for bit and the launch counts are phase 4's;
    prints the step medians, the peak device memory above the phase's start
    and overlap_report's numbers."""
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch import FluxPipeline
    from diffusion_rs_tpu_torch.models.flux_streaming import StreamedFlux
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.pipelines.sampling import pack_latents
    from diffusion_rs_tpu_torch.util.capacity import tree_device_bytes

    flux_bytes = tree_device_bytes(pipe.flux_params)
    require_host_memory(flux_bytes * 5 // 4, "phase 4d (Offloading.Stream)")
    torch.cuda.synchronize()
    avail, rss = host_memory()["MemAvailable"], process_rss()
    t0 = time.perf_counter()
    sf = StreamedFlux(pipe.flux_params, cfgs["flux_cfg"], device="cuda")
    pack_s = time.perf_counter() - t0
    n_blocks = len(sf.dbl_bufs) + len(sf.sgl_bufs)
    print(f"phase 4d: packed {n_blocks} blocks ({sf.dbl_bufs[0].numel()} bytes a double "
          f"block, {sf.sgl_bufs[0].numel()} a single) into {sf.bytes_per_step / 2**30:.3f} "
          f"GiB of pinned host memory in {pack_s:.2f} s (the transformer's weights "
          f"{flux_bytes / 2**30:.3f} GiB); the process's VmRSS grew by "
          f"{(process_rss() - rss) / 2**30:.3f} GiB, MemAvailable fell by "
          f"{(avail - host_memory()['MemAvailable']) / 2**30:.3f} GiB")
    spipe = FluxPipeline(
        flux_params=None, t5_params=pipe.t5_params, clip_params=pipe.clip_params,
        vae_params=pipe.vae_params, streamed=sf, scheduler=pipe.scheduler,
        t5_tokenizer=pipe.t5_tokenizer, clip_tokenizer=pipe.clip_tokenizer,
        dtype=pipe.dtype, device="cuda", **cfgs)
    captured = {}
    stage = spipe._denoise_streamed

    def capture(*a):
        captured["args"] = a
        captured["latent"] = stage(*a)
        return captured["latent"]

    spipe._denoise_streamed = capture
    t0 = time.perf_counter()
    spipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=1, guidance_scale=3.5, seed=7))
    print(f"phase 4d warm-up image (1 step) in {time.perf_counter() - t0:.1f} s")
    params = DiffusionGenerationParams(height=1024, width=1024, num_steps=steps,
                                       guidance_scale=3.5, seed=7)
    for look in ("2", "1"):
        with env(DIFFUSION_RS_TPU_STREAM_LOOKAHEAD=look):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            img = spipe.forward_arrays(prompts, params)
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        steps_ms = [x * 1e3 for x in spipe.timings["steps_s"]]
        same = bool(torch.equal(captured["latent"], ref["latent"]))
        print(f"phase 4d lookahead {look}: image {wall:.3f} s, step median "
              f"{statistics.median(steps_ms):.2f} ms ({min(steps_ms):.1f}-{max(steps_ms):.1f}; "
              f"phase 4 resident {ref['step_ms']:.2f}), peak allocated above the phase's "
              f"start {peak:.2f} GiB (the ring {int(look) + 1} x "
              f"{max(sf.dbl_bufs[0].numel(), sf.sgl_bufs[0].numel()) / 2**30:.3f} GiB; "
              f"phase 4: peak {ref['peak']:.2f} GiB with {ref['weights']:.2f} GiB of weights); "
              f"latent equal to phase 4's: {same}; card {card_state()}")
        print(f"phase 4d lookahead {look} launches { {k: v for k, v in counts.items() if v} }")
        if counts != want:
            raise SystemExit(f"phase 4d lookahead {look}: launch counts {counts} differ "
                             f"from phase 4's {want}")
        if not same or img.shape != (1, 1024, 1024, 3):
            raise SystemExit(f"phase 4d lookahead {look}: latent equal {same}, image "
                             f"{img.shape}; {summed_rel(captured['latent'], ref['latent']):.3e}"
                             " from phase 4's")
    txt, y, _, guidance, noise = captured["args"]
    img = pack_latents(noise.to(spipe.dtype))
    rep = sf.overlap_report(img, txt, y, guidance, spipe._pe(txt, noise), iters=2)
    print("phase 4d overlap_report " + json.dumps(rep))


def write_bfl_q4_0_file(path, cfg, seed: int) -> dict:
    """A BFL-named FLUX GGUF written by the port's own writer: every linear
    Q4_0 (random codes, per-block f16 scales around 0.25/sqrt(K)), biases
    small random f32, QK-norm scales ones. Returns name -> (fmt, shape, raw)."""
    import numpy as np

    from diffusion_rs_tpu_torch.io.gguf import write_gguf

    rng = np.random.default_rng(seed)
    h, m, hd = cfg.hidden_size, cfg.mlp_size, cfg.head_dim
    linears = {"img_in": (h, cfg.in_channels), "txt_in": (h, cfg.joint_attention_dim),
               "time_in.in_layer": (h, 256), "time_in.out_layer": (h, h),
               "vector_in.in_layer": (h, cfg.pooled_projection_dim),
               "vector_in.out_layer": (h, h), "guidance_in.in_layer": (h, 256),
               "guidance_in.out_layer": (h, h),
               "final_layer.adaLN_modulation.1": (2 * h, h),
               "final_layer.linear": (cfg.in_channels, h)}
    norms = []
    for i in range(cfg.num_layers):
        p = f"double_blocks.{i}"
        for s in ("img", "txt"):
            linears.update({f"{p}.{s}_mod.lin": (6 * h, h), f"{p}.{s}_attn.qkv": (3 * h, h),
                            f"{p}.{s}_attn.proj": (h, h), f"{p}.{s}_mlp.0": (m, h),
                            f"{p}.{s}_mlp.2": (h, m)})
            norms += [f"{p}.{s}_attn.norm.query_norm.scale", f"{p}.{s}_attn.norm.key_norm.scale"]
    for i in range(cfg.num_single_layers):
        p = f"single_blocks.{i}"
        linears.update({f"{p}.linear1": (3 * h + m, h), f"{p}.linear2": (h, h + m),
                        f"{p}.modulation.lin": (3 * h, h)})
        norms += [f"{p}.norm.query_norm.scale", f"{p}.norm.key_norm.scale"]
    tensors = {}
    for name, (n_out, k_in) in linears.items():
        blocks = rng.integers(0, 256, size=(n_out * k_in // 32, 18), dtype=np.uint8)
        d = rng.uniform(0.5, 1.5, size=len(blocks)) * (0.25 * k_in ** -0.5)
        blocks[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
        tensors[f"{name}.weight"] = ("q4_0", (n_out, k_in), blocks)
        b = (rng.standard_normal(n_out) * 0.02).astype(np.float32)
        tensors[f"{name}.bias"] = ("f32", (n_out,), b)
    for name in norms:
        tensors[name] = ("f32", (hd,), np.ones(hd, np.float32))
    write_gguf(str(path), tensors, metadata={"general.name": "flux-bfl-q4_0-synthetic"})
    return tensors


def gguf_round_trip(encoders, prompts):
    """Phase 6: a full-width BFL Q4_0 file with 1 double + 1 single block
    through the writer, ``load_flux_transformer`` and one 1024x1024 step."""
    import dataclasses
    import tempfile

    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.pipelines.loader import load_flux_transformer
    from diffusion_rs_tpu_torch.quant.gguf_quants import gguf_to_canonical
    from diffusion_rs_tpu_torch.quant.qtensor import concat_n, slice_n

    want_cfg = dataclasses.replace(FluxConfig(), num_layers=1, num_single_layers=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/flux1-dev-q4_0-1+1.gguf"
        t0 = time.perf_counter()
        tensors = write_bfl_q4_0_file(path, want_cfg, seed=3)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, cfg = load_flux_transformer(path, FluxConfig(), torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        import os
        size_mb = os.path.getsize(path) / 1e6
    if cfg != want_cfg:
        raise SystemExit(f"flux_config_from_bfl derived {cfg}, expected {want_cfg}")
    h = cfg.hidden_size

    def host(name):
        fmt, shape, raw = tensors[f"{name}.weight"]
        return gguf_to_canonical(fmt, raw.tobytes(), shape)

    mod = host("final_layer.adaLN_modulation.1")
    checks = {
        "img_in": (params["img_in"].w, host("img_in")),
        "double_blocks.0.img_attn.qkv": (params["double"]["img_attn"]["qkv"].w.map(
            lambda t: t[0]), host("double_blocks.0.img_attn.qkv")),
        "single_blocks.0.linear1": (params["single"]["qkv_mlp"].w.map(lambda t: t[0]),
                                    host("single_blocks.0.linear1")),
        "single_blocks.0.linear2": (params["single"]["linear2"].w.map(lambda t: t[0]),
                                    host("single_blocks.0.linear2")),
        "final_layer.adaLN_modulation.1 (halves swapped)": (
            params["final"]["mod"].w, concat_n([slice_n(mod, h, 2 * h), slice_n(mod, 0, h)])),
    }
    for name, (dev_qt, host_qt) in checks.items():
        for field in ("packed", "scale", "bias"):
            a, b = getattr(dev_qt, field), getattr(host_qt, field)
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise SystemExit(f"loaded {name}.{field} differs from the host decode")
        if (dev_qt.kind, dev_qt.group, dev_qt.split, dev_qt.shape) != (
                host_qt.kind, host_qt.group, host_qt.split, host_qt.shape):
            raise SystemExit(f"loaded {name} meta differs from the host decode")
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg},
                         {**encoders["params"], "flux_params": params}, device="cuda")
    _cuda.reset_launch_counts()
    img = pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=1, guidance_scale=3.5, seed=7))
    counts = _cuda.launch_counts()
    want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), "qmm_nf4": 168, "qmm_affine": 22,
                          "flash_fwd": 2})
    print(f"gguf round trip: {size_mb:.1f} MB BFL Q4_0 file (1+1 blocks, hidden {h}) "
          f"written in {t_write:.1f} s, loaded in {t_load:.1f} s; config {cfg}; "
          f"{len(checks)} tensors equal to the host decode; 1-step image "
          f"{pipe.timings['steps_s'][0] * 1e3:.1f} ms step; launches {counts} "
          f"(expected {want})")
    if counts != want:
        raise SystemExit(f"gguf round trip launch counts {counts} differ from {want}")
    if img.shape != (1, 1024, 1024, 3) or img.dtype.name != "uint8":
        raise SystemExit(f"bad image: {img.dtype} {img.shape}")


def timed_image(name: str, pipe, prompts, steps: int, want: dict, t_init=None):
    """A 1-step warm-up, one timed ``steps``-step 1024x1024 image with exact
    launch counts (reset just before it, read just after), then a profiled
    1-step image. Returns the counts and the final latent."""
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda

    captured = {}
    denoise_stage = pipe._denoise

    def capture_denoise(*a):
        captured["latent"] = denoise_stage(*a)
        return captured["latent"]

    pipe._denoise = capture_denoise
    pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=1, guidance_scale=3.5, seed=7))
    before = card_state()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=steps, guidance_scale=3.5, seed=7))
    wall = time.perf_counter() - t0
    print(f"{name} card (SM clock, max, power, temperature, throttle reasons) before: "
          f"{before}; after: {card_state()}")
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), **want})
    made = "" if t_init is None else f" (weights made on the card in {t_init:.1f} s)"
    steps_ms = [x * 1e3 for x in tm["steps_s"]]
    median = statistics.median(steps_ms)
    print(f"{name} image {wall:.3f} s{made}: encode {tm['encode_s'] * 1e3:.1f} ms, step median "
          f"{median:.2f} ms ({min(steps_ms):.1f}-{max(steps_ms):.1f}), "
          f"steps ms {[round(x, 1) for x in steps_ms]}, decode {tm['decode_s'] * 1e3:.1f} ms, "
          f"peak memory {peak:.2f} GiB ({capacity_estimate(pipe)})")
    print(f"{name} launches { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }, every other kernel 0)")
    lat = captured["latent"]
    if counts != want:
        raise SystemExit(f"{name} launch counts {counts} differ from its path's {want}")
    if img.shape != (1, 1024, 1024, 3) or img.dtype.name != "uint8":
        raise SystemExit(f"bad {name} image: {img.dtype} {img.shape}")
    if tuple(lat.shape) != (1, 4096, 64) or not torch.isfinite(lat).all():
        raise SystemExit(f"bad {name} latent: {tuple(lat.shape)}, finite "
                         f"{bool(torch.isfinite(lat).all())}")
    profile_image(pipe, prompts)
    return counts, lat, median


def capacity_estimate(pipe, batch: int = 1) -> str:
    """check_denoise_capacity's numbers for a 1024x1024 image of ``pipe`` at
    ``batch``: the transformer's resident bytes plus the activation estimate
    (util/capacity.py), printed beside a measured peak."""
    from diffusion_rs_tpu_torch.util.capacity import (
        estimate_denoise_activation_bytes, tree_device_bytes)

    w = tree_device_bytes(pipe.flux_params)
    act = estimate_denoise_activation_bytes(batch, 4096, 512, pipe.flux_cfg.hidden_size)
    return (f"capacity estimate {(w + act) / 2**30:.2f} GiB = {w / 2**30:.2f} weights + "
            f"{act / 2**30:.2f} activations")


def gguf_image(kind: str, encoders, prompts, steps: int, cfg):
    """Phase 7: FLUX.1-dev of config ``cfg`` in ``kind`` (BFL layout) at
    1024x1024."""
    import torch

    from diffusion_rs_tpu_torch.util.synthetic import init_flux_params_quantized

    gc.collect()  # the previous image's pipeline sits in a reference cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_flux_params_quantized(1, cfg, kind=kind, layout="bfl", device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg},
                         {**encoders["params"], "flux_params": params}, device="cuda")
    n = flux_launches(cfg)
    want = {"qmm_nf4": 168, "qmm_affine": n["bfl"] * steps, "flash_fwd": n["attention"] * steps}
    return timed_image(kind, pipe, prompts, steps, want, t_init)


def flux_launches(cfg) -> dict:
    """Launches per step of a FLUX config with L double and Ls single
    blocks: its quantized linears (every one but final.proj, N = 64, which
    takes dequantize + matmul; 9 embedders and the final modulation), by
    layout, and its attention calls (FLUX.1-dev: 503, 313, 76, 161, 275, 57).
    ``diffusers``: per double block two modulations and q, k, v, proj, mlp
    in and out per stream; per single block q, k, v, proj_mlp, linear2 and
    the modulation. ``bfl``: q|k|v and the single blocks' linear1 fused.
    ``grouped``: the double blocks' img/txt pairs as grouped calls (fused
    q|k|v, proj, mlp in, mlp out), with the rest every stream fused
    (``grouped_fused_rest``, configs A and B) or the single blocks unfused
    (``grouped_rest``, config D)."""
    L, Ls = cfg.num_layers, cfg.num_single_layers
    return dict(diffusers=14 * L + 6 * Ls + 9, bfl=10 * L + 3 * Ls + 9, grouped=4 * L,
                grouped_fused_rest=2 * L + 3 * Ls + 9, grouped_rest=2 * L + 6 * Ls + 9,
                attention=L + Ls)


# The attention entries of the [B, H, S, D] layout (one launch a call) and
# of the sp ring (K14: SP launches a call), after which the default layout
# launches its attention prologue once a call.
BHSD_ATTENTION = ("flash_fwd", "flash_s8", "flash_s8pv", "flash_s8_s8pv")


def with_prologue(want: dict) -> dict:
    """``want``, a path's exact launch counts, with the default layout's
    attention prologue: one ``qk_norm_rope`` launch per attention call of
    the [B, H, S, D] layout, read off the attention entries in ``want``.
    The fused-RoPE layouts' entries (``flash_sm``, ``flash_rope``) call no
    prologue. The key is added only where ``want`` has it or it is not 0,
    so that it fits both zero-filled counts and a rank's nonzero ones."""
    calls = (sum(want.get(e, 0) for e in BHSD_ATTENTION)
             + sum(want.get(e, 0) for e in LSE_ENTRIES) // SP)
    return {**want, "qk_norm_rope": calls} if calls or "qk_norm_rope" in want else dict(want)


# Phases 8-9: (name, weight kind, layout and seed as phase 4 / phase 7 made
# them, fuse, attention layout, the kernels of the other linears, of the
# grouped pairs and of attention, launches per image, whether the config
# keeps FLUX.1-dev's depth: config A's latent is held against phase 4's).
LAYOUT_CONFIGS = (
    ("config A (q8t)", "q8t", "diffusers", 0, FUSE_ALL_GROUPED, "inkernel",
     ("qmm_s8", "qmm_grouped_s8", "flash_rope"), {"qmm_nf4": 96}, True),
    ("config B (Q4_0)", "q4_0", "bfl", 1, "grouped", "seqmajor",
     ("qmm_affine", "qmm_grouped_affine", "flash_sm"), {"qmm_nf4": 96}, False),
)
# bf16 latents of the same weights and noise through another column order
# (the half-split re-layout changes f32 summation orders); a wrong kernel
# moves them by far more
LAYOUT_LATENT_TOL = 0.1


def layout_image(config, encoders, prompts, steps: int, ref_latent, cfg):
    """Phases 8-9: FLUX.1-dev of config ``cfg`` (or full depth, as the
    config says) through the loader's layout transform, at 1024x1024.
    Returns the counts, the fused T5 params and the latent's summed-rel
    distance from ``ref_latent``."""
    import torch

    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.pipelines.loader import apply_layout_options
    from diffusion_rs_tpu_torch.util.synthetic import init_flux_params_quantized

    name, kind, layout, seed, fuse, attn, kernels, per_image, full_depth = config
    cfg = FluxConfig() if full_depth else cfg
    n = flux_launches(cfg)
    per_step = dict(zip(kernels, (n["grouped_fused_rest"], n["grouped"], n["attention"])))
    if "flash_rope" in kernels:  # K7: the rotation pass before each attention call
        per_step["rope_qk"] = n["attention"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_flux_params_quantized(seed, cfg, kind=kind, layout=layout, device="cuda")
    with env(DIFFUSION_RS_TPU_FUSED_ROPE="1"):
        params, cfg, t5_params = apply_layout_options(
            params, cfg, encoders["params"]["t5_params"], fuse=fuse)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    if not (cfg.rope_fused and cfg.grouped_qmm and "qkv" in t5_params["blocks"]["attn"]):
        raise SystemExit(f"{name}: the layout transform did not apply ({cfg})")
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg},
                         {**encoders["params"], "t5_params": t5_params,
                          "flux_params": params}, device="cuda")
    want = {**{k: v * steps for k, v in per_step.items()}, **per_image}
    print(f"{name}: fuse={fuse!r}, DIFFUSION_RS_TPU_FUSED_ROPE=1, "
          f"DIFFUSION_RS_TPU_ATTN_LAYOUT={attn}, fused T5")
    with env(DIFFUSION_RS_TPU_ATTN_LAYOUT=attn):
        counts, lat, _ = timed_image(name, pipe, prompts, steps, want, t_init)
    dist = summed_rel(lat, ref_latent)
    print(f"{name} latent vs the same weights in the default layout: summed-rel {dist:.3e}")
    if not dist <= LAYOUT_LATENT_TOL:
        raise SystemExit(f"{name} latent is {dist:.3e} from the default layout's")
    return counts, t5_params, dist


# Config C's latent against phase 4's (same weights and noise, bf16
# attention): JAX holds each int8 attention within 2e-2 of the f32 reference
# (tests/test_ops.py:387). The Euler steps integrate the velocity over one
# unit of sigma, so a velocity within 2e-2 moves the latent by that order;
# x2.5 allows for the q8t activation quantize, which turns even f32
# summation-order changes into 1e-2 at 4 steps (config A).
INT8_LATENT_TOL = 5e-2


def int8_attention_images(pipe, prompts, steps: int, ref_latent):
    """Config C: phase 4's q8t pipeline with DIFFUSION_RS_TPU_ATTN_S8=1 and
    ATTN_S8PV=1, run as phase 7 runs its images, its latent held against
    phase 4's; then a 1-step image under each knob alone with exact
    launches, and ``s8pv_dropped_mass`` of the first attention call's q/k
    (double block 0, first step). Returns the int8 entry points' launch
    counts and the latent distance."""
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.models import flux as flux_model
    from diffusion_rs_tpu_torch.ops import _cuda, flash

    name = "config C (q8t, ATTN_S8=1, ATTN_S8PV=1)"
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with attention_knobs(True, True):
        counts, lat, _ = timed_image(name, pipe, prompts, steps, {
            "qmm_s8": 503 * steps, "qmm_nf4": 168, "flash_s8_s8pv": 57 * steps,
            "flash_quant": 57 * steps})
    dist = summed_rel(lat, ref_latent)
    print(f"{name} latent vs phase 4's (bf16 attention): summed-rel {dist:.3e} "
          f"(band {INT8_LATENT_TOL:g})")
    if not dist <= INT8_LATENT_TOL:
        raise SystemExit(f"{name} latent is {dist:.3e} from phase 4's")
    out = {"flash_s8_s8pv": counts["flash_s8_s8pv"], "flash_quant": counts["flash_quant"]}
    seen = {}
    sdpa_merged = flux_model.sdpa_merged

    def first_call(q, k, v, *a, **kw):
        seen.setdefault("qk", (q, k))
        return sdpa_merged(q, k, v, *a, **kw)

    one = DiffusionGenerationParams(height=1024, width=1024, num_steps=1,
                                    guidance_scale=3.5, seed=7)
    for entry in ("flash_s8", "flash_s8pv"):
        s8, s8_pv = INT8_MODES[entry]
        with attention_knobs(s8, s8_pv):
            _cuda.reset_launch_counts()
            flux_model.sdpa_merged = first_call
            try:
                pipe.forward_arrays(prompts, one)
            finally:
                flux_model.sdpa_merged = sdpa_merged
            c = _cuda.launch_counts()
        want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), "qmm_s8": 503, "qmm_nf4": 168,
                              entry: 57, "flash_quant": 57})
        print(f"config C, {ATTN_KNOBS[s8_pv]}=1 alone, 1-step image: launches "
              f"{ {k: v for k, v in c.items() if v} } (expected "
              f"{ {k: v for k, v in want.items() if v} })")
        if c != want:
            raise SystemExit(f"1-step image with {entry} alone: launches {c} differ from {want}")
        out[entry] = c[entry]
    q, k = seen["qk"]
    dropped = flash.s8pv_dropped_mass(q, k)
    print(f"s8pv_dropped_mass of the first attention call (double block 0, first step, "
          f"q/k {tuple(q.shape)}): max {float(dropped.max()):.3e}, mean "
          f"{float(dropped.mean()):.3e} over {dropped.numel()} rows")
    del seen, q, k, dropped
    return out, dist


NF4_SEED = 2
# A fast16 latent against the f32 decode's (same weights and noise): the
# 16-bit decode rounds each weight once more (2.3e-3 summed-rel per product
# for nf4 and Q4_0, 4.7e-3 for Q4_K, whose offset b/s is no integer), through
# every block and step: 1.5e-2 (nf4) and 6.1e-2 (Q4_K) after 4 steps, 6.3e-3
# and 5.7e-2 after 28, on an H100. Each band is about three times its config's
# larger reading; E's stays under the whole q4_k error (E0 against the dense
# preset: 0.19-0.22). The kernel phase holds the decoded weights at max-abs 0.
FAST16_F_LATENT_TOL = 5e-2
FAST16_E_LATENT_TOL = 0.15


def nf4_images(encoders, prompts, steps: int, cfg):
    """Configs D0 and D: FLUX.1-dev nf4 made on the card, D0 in the default
    layout (K2), D after ``fuse="grouped"`` (K11 for the img/txt pairs, K2
    for the rest), with config A's fused T5. D's latent must equal D0's bit
    for bit. Returns D's launch counts."""
    import torch

    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.pipelines.loader import apply_layout_options
    from diffusion_rs_tpu_torch.util.synthetic import init_flux_params_quantized

    t5 = encoders["params"]["t5_params"]
    t5_per_image = T5Config().num_layers * (len(t5["blocks"]["attn"]) + len(t5["blocks"]["ff"]))
    n = flux_launches(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_flux_params_quantized(NF4_SEED, cfg, kind="nf4", device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg},
                         {**encoders["params"], "flux_params": params}, device="cuda")
    want = {"qmm_nf4": n["diffusers"] * steps + t5_per_image,
            "flash_fwd": n["attention"] * steps}
    _, lat0, med0 = timed_image("config D0 (nf4)", pipe, prompts, steps, want, t_init)
    # config F: D0's weights with the fast16 decode (K12 on FLUX and T5)
    want = {"qmm_nf4_fast16": n["diffusers"] * steps + t5_per_image,
            "flash_fwd": n["attention"] * steps}
    with env(DIFFUSION_RS_TPU_QMM_FAST16="1"):
        counts_f, lat_f, med_f = timed_image("config F (nf4, DIFFUSION_RS_TPU_QMM_FAST16=1)",
                                             pipe, prompts, steps, want)
    dist = summed_rel(lat_f, lat0)
    print(f"config F latent vs config D0's (f32 decode): summed-rel {dist:.3e} (band "
          f"{FAST16_F_LATENT_TOL:g}); step median F {med_f:.2f} ms beside D0 {med0:.2f} ms")
    if not (0.0 < dist <= FAST16_F_LATENT_TOL):
        raise SystemExit(f"config F's latent is {dist:.3e} from D0's")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg, _ = apply_layout_options(params, cfg, t5, fuse="grouped")
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    if not (cfg.grouped_qmm and "qkv" in params["double"]["img_attn"]):
        raise SystemExit(f"config D: the layout transform did not apply ({cfg})")
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg},
                         {**encoders["params"], "flux_params": params}, device="cuda")
    want = {"qmm_nf4": n["grouped_rest"] * steps + t5_per_image,
            "qmm_grouped_nf4": n["grouped"] * steps, "flash_fwd": n["attention"] * steps}
    print(f'config D (nf4, fuse="grouped"): img/txt q|k|v fused and grouped in '
          f"{t_fuse:.1f} s")
    counts, lat, _ = timed_image("config D (nf4, grouped)", pipe, prompts, steps, want)
    max_abs = float((lat.float() - lat0.float()).abs().max())
    print(f"config D latent vs config D0's: max-abs {max_abs:.3e}")
    if max_abs != 0.0:
        raise SystemExit(f"config D's latent differs from D0's: max-abs {max_abs:.3e}")
    return {**counts, "qmm_nf4_fast16": counts_f["qmm_nf4_fast16"]}


ISQ_SEED = 4
# The imatrix refinement on the card against the CPU: the share of codes
# another order of the group sums may move at a tie, and the relative change
# of the importance-weighted error (tests/test_torch_isq.py's bands, far
# inside the weighted-vs-unweighted gap)
CODE_MOVE_BAND = 1e-3
WEIGHTED_ERR_BAND = 1e-3


def count_qmm_linears(params) -> int:
    """Quantized-matmul launches per forward of a model's params: Linears
    whose weight is a QuantizedTensor the kernels tile (``supports``; the
    others take dequantize + matmul), stacked ones once per layer."""
    from diffusion_rs_tpu_torch.ops.linear import Linear
    from diffusion_rs_tpu_torch.ops.qmatmul import supports
    from diffusion_rs_tpu_torch.quant import QuantizedTensor

    if isinstance(params, Linear):
        w = params.w
        if isinstance(w, QuantizedTensor) and supports(w):
            return w.packed.shape[0] if w.packed.dim() == 3 else 1
        return 0
    if isinstance(params, dict):
        return sum(count_qmm_linears(v) for v in params.values())
    return 0


def _plane(params, name: str):
    """Layer ``i`` of the Linear at ``prefix.i.rest`` (or the Linear at a
    plain dotted name) of a param tree: its weight."""
    parts = name.split(".")
    layer = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else None
    node = params
    for key in parts[:1] + parts[2 if layer is not None else 1:]:
        node = node[key]
    w = node.w
    if layer is None:
        return w
    return w.map(lambda t: t[layer]) if hasattr(w, "map") else w[layer]


def check_isq_planes(pick: dict, flux_q, t5_q, imat: dict) -> None:
    """Full-size planes quantized on the CPU with the same function as on
    the card: equal codes and planes without the imatrix, and, for the FLUX
    planes the loader refined with it, within CODE_MOVE_BAND /
    WEIGHTED_ERR_BAND of the CPU's refinement."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch.quant import dequantize, unpack4
    from diffusion_rs_tpu_torch.quant.isq import isq_quantize_weight

    for name, w in pick.items():
        cpu_w = w.float().cpu()
        card = isq_quantize_weight(w, ISQ_TARGET)
        cpu = isq_quantize_weight(cpu_w, ISQ_TARGET)
        equal = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                    for f in ("packed", "scale", "bias"))
        line = f"ISQ plane {name} {tuple(w.shape)}: card vs CPU without the imatrix equal {equal}"
        if not equal:
            raise SystemExit(line)
        imp = imat.get(name)
        if imp is not None:
            got = _plane(flux_q, name).map(lambda t: t.cpu())
            want = isq_quantize_weight(cpu_w, ISQ_TARGET, imatrix=imp)
            moved = float((unpack4(got.packed, got.split) != unpack4(want.packed, want.split))
                          .float().mean())
            w64 = cpu_w.double().numpy()

            def werr(qt):
                d = w64 - dequantize(qt, torch.float32).double().numpy()
                return float((imp.astype(np.float64)[:, None] * d * d).sum())

            e_got, e_want, e_plain = werr(got), werr(want), werr(cpu)
            rel = abs(e_got - e_want) / e_want
            line += (f"; with it: codes moved {moved:.3e}, weighted error {e_got:.6e} vs CPU "
                     f"{e_want:.6e} (rel {rel:.3e}; unweighted {e_plain:.6e})")
            if not (moved <= CODE_MOVE_BAND and rel <= WEIGHTED_ERR_BAND):
                raise SystemExit(line)
        print(line)


def isq_images(encoders, prompts, steps: int, cfg):
    """The dense preset (dev-1024-bf16: bf16 FLUX.1-dev of config ``cfg``
    and T5-XXL made on the card), then configs E / E0: those weights through the
    loader's weight options (q4_k, a seeded imatrix over every FLUX linear,
    a rank-16 LoRA; T5 follows isq), run with DIFFUSION_RS_TPU_QMM_FAST16=1
    (K13) and unset (K4). Returns config E's launch counts."""
    import tempfile

    import torch

    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.pipelines.loader import apply_weight_options
    from diffusion_rs_tpu_torch.util import synthetic as syn
    from diffusion_rs_tpu_torch.util.capacity import tree_device_bytes

    attention = flux_launches(cfg)["attention"] * steps
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flux = syn.init_flux_params(ISQ_SEED, cfg, device="cuda")
    t5 = syn.init_t5_params(ISQ_SEED + 1, T5Config(), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    print(f"dense preset (dev-1024-bf16): FLUX.1-dev {tree_device_bytes(flux) / 1e9:.2f} GB, "
          f"T5-XXL {tree_device_bytes(t5) / 1e9:.2f} GB of bf16 weights")
    params = {**encoders["params"], "t5_params": t5, "flux_params": flux}
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg}, params, device="cuda")
    _, lat_dense, med_dense = timed_image("dense bf16 (dev-1024-bf16)", pipe, prompts, steps,
                                          {"flash_fwd": attention}, t_init)
    del pipe, params
    pick = {"double.0.img_attn.q": flux["double"]["img_attn"]["q"].w[0],
            "double.0.img_mlp.in": flux["double"]["img_mlp"]["in"].w[0],
            "single.0.linear2": flux["single"]["linear2"].w[0],
            "t5 blocks.0.ff.wi_0": t5["blocks"]["ff"]["wi_0"].w[0]}
    with tempfile.TemporaryDirectory() as tmp:
        imat = write_flux_imatrix(f"{tmp}/imatrix.dat", flux, seed=ISQ_SEED + 2)
        pairs = write_flux_lora(f"{tmp}/lora.safetensors", cfg, seed=ISQ_SEED + 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flux_q, t5_q = apply_weight_options(flux, cfg, t5, isq=ISQ_TARGET,
                                            imatrix=f"{tmp}/imatrix.dat",
                                            lora=f"{tmp}/lora.safetensors")
        torch.cuda.synchronize()
        t_isq = time.perf_counter() - t0
    print(f"ISQ {ISQ_TARGET} with a {len(imat)}-entry imatrix and a {pairs}-pair rank-16 LoRA "
          f"on the card in {t_isq:.1f} s: FLUX {tree_device_bytes(flux_q) / 1e9:.2f} GB, "
          f"T5 {tree_device_bytes(t5_q) / 1e9:.2f} GB (T5 "
          f"{t5_q['blocks']['attn']['q'].w.kind}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if t5_q["blocks"]["attn"]["q"].w.kind != ISQ_TARGET:
        raise SystemExit("T5 did not follow isq under the card's budget")
    check_isq_planes(pick, flux_q, t5_q, imat)
    del flux, t5, pick
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipeline({**encoders["cfgs"], "flux_cfg": cfg},
                         {**encoders["params"], "t5_params": t5_q, "flux_params": flux_q},
                         device="cuda")
    per_image = count_qmm_linears(flux_q) * steps + count_qmm_linears(t5_q)
    with env(DIFFUSION_RS_TPU_QMM_FAST16="1"):
        counts, lat_e, med_e = timed_image(
            f"config E ({ISQ_TARGET} ISQ + imatrix + LoRA, DIFFUSION_RS_TPU_QMM_FAST16=1)",
            pipe, prompts, steps, {"qmm_affine_fast16": per_image, "flash_fwd": attention})
    with env(DIFFUSION_RS_TPU_QMM_FAST16=None):
        _, lat_e0, med_e0 = timed_image("config E0 (config E's weights, f32 decode)", pipe,
                                        prompts, steps,
                                        {"qmm_affine": per_image, "flash_fwd": attention})
    dist = summed_rel(lat_e, lat_e0)
    print(f"config E latent vs E0's: summed-rel {dist:.3e} (band {FAST16_E_LATENT_TOL:g}); "
          f"E0 vs the dense preset's: {summed_rel(lat_e0, lat_dense):.3e}; step medians E "
          f"{med_e:.2f} ms, E0 {med_e0:.2f} ms, dense {med_dense:.2f} ms")
    if not (0.0 < dist <= FAST16_E_LATENT_TOL):
        raise SystemExit(f"config E's latent is {dist:.3e} from E0's")
    return counts


def offloaded_loads(root, prompts, dense) -> None:
    """The directory at ``root`` loaded again through ``Pipeline(offloading=
    Offloading.Full | Stream, device="cuda")``, the user's entry point:
    under Full every component's host copy must be pinned, under Stream the
    transformer's blocks pinned and the encoders and the VAE on the card.
    A 1-step 1024x1024 image of each (its latent, then the decoded image)
    must equal ``dense``'s (the resident load of the same directory) bit
    for bit, with the same launches. Prints each load's time and the
    process's resident memory before and after it."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams, ModelSource, Offloading
    from diffusion_rs_tpu_torch import Pipeline
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.util.tree import tree_leaves

    params = DiffusionGenerationParams(height=1024, width=1024, num_steps=1,
                                       guidance_scale=3.5, seed=7)

    def run(pipe):
        _cuda.reset_launch_counts()
        lat = pipe.forward_arrays(prompts, params, output_type="latent")
        return lat, pipe.forward_arrays(prompts, params), _cuda.launch_counts()

    ref_lat, ref_img, ref_counts = run(dense)
    for mode in (Offloading.Full, Offloading.Stream):
        gc.collect()
        before = process_rss()
        t0 = time.perf_counter()
        pipe = Pipeline(ModelSource.from_model_id(str(root)), silent=True, offloading=mode,
                        device="cuda")._inner
        load_s = time.perf_counter() - t0
        after = process_rss()
        if mode is Offloading.Full:
            pinned = all(t.is_pinned() for n in ("t5", "clip", "vae", "flux")
                         for t in tree_leaves(getattr(pipe, f"{n}_params")))
            on_card = True
        else:
            pinned = all(b.is_pinned() for b in pipe.streamed.dbl_bufs + pipe.streamed.sgl_bufs)
            on_card = all(t.is_cuda for n in ("t5", "clip", "vae")
                          for t in tree_leaves(getattr(pipe, f"{n}_params")))
        lat, img, counts = run(pipe)
        same = bool(np.array_equal(lat, ref_lat) and np.array_equal(img, ref_img))
        print(f"loaded with offloading={mode.name} in {load_s:.1f} s: the process's VmRSS "
              f"{before / 2**30:.2f} -> {after / 2**30:.2f} GiB; host copies pinned {pinned}, "
              f"resident components on the card {on_card}; 1-step latent and image equal to "
              f"the resident load's: {same}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if not (pinned and on_card and same) or counts != ref_counts:
            raise SystemExit(f"offloading={mode.name} through the loader: pinned {pinned}, "
                             f"on the card {on_card}, equal {same}, launches {counts} against "
                             f"{ref_counts}")
        del pipe


def cli_image(model_dir: str, out: str, prompt: str) -> None:
    """One 1024x1024 1-step image through ``cli.main`` from the directory;
    the file it writes must be a 1024x1024 PNG."""
    from diffusion_rs_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(["--model-id", model_dir, "--prompt", prompt, "-o", out, "--num-steps", "1",
                   "--height", "1024", "--width", "1024", "--seed", "7", "--silent"])
    with open(out, "rb") as f:
        png = f.read()
    size = tuple(int.from_bytes(png[i:i + 4], "big") for i in (16, 20))
    print(f"cli: rc {rc}, {len(png)} bytes, {size[0]}x{size[1]} PNG in "
          f"{time.perf_counter() - t0:.1f} s (load included)")
    if rc != 0 or png[:8] != b"\x89PNG\r\n\x1a\n" or size != (1024, 1024):
        raise SystemExit(f"cli.main: rc {rc}, PNG {png[:8]!r}, size {size}")


def isq_file_round_trip(prompts) -> int:
    """A diffusers-layout directory at full width (FLUX.1-dev with 1 double
    + 1 single block, T5-XXL cut to 1 layer, CLIP-L and the VAE whole, bf16)
    written by the port, then ``Pipeline(isq="q4_k", imatrix=, lora=)`` onto
    the card under DIFFUSION_RS_TPU_QMM_FAST16=1: its quantized planes and
    LoRA terms must equal the loader's weight options applied in memory to
    the same directory's dense load, and one 1024x1024 step runs with exact
    K13 launches. Returns the K13 launches."""
    import dataclasses
    import tempfile

    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams, ModelSource, Pipeline
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.pipelines.loader import apply_weight_options, load_pipeline
    from diffusion_rs_tpu_torch.util.synthetic import write_diffusers_dir

    cfgs = dict(flux_cfg=dataclasses.replace(FluxConfig(), num_layers=1, num_single_layers=1),
                t5_cfg=dataclasses.replace(T5Config(), num_layers=1),
                clip_cfg=ClipTextConfig(), vae_cfg=VAEConfig())
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_diffusers_dir(f"{tmp}/flux", cfgs, seed=ISQ_SEED + 4, device="cuda")
        t_write = time.perf_counter() - t0
        dense = load_pipeline(ModelSource.from_model_id(f"{tmp}/flux"), silent=True,
                              device="cuda")
        if dense.flux_cfg != cfgs["flux_cfg"]:
            raise SystemExit(f"the directory loads as {dense.flux_cfg}")
        offloaded_loads(f"{tmp}/flux", prompts, dense)
        cli_image(f"{tmp}/flux", f"{tmp}/cli.png", prompts[0])
        write_flux_imatrix(f"{tmp}/imatrix.dat", dense.flux_params, seed=ISQ_SEED + 5)
        write_flux_lora(f"{tmp}/lora.safetensors", cfgs["flux_cfg"], seed=ISQ_SEED + 6)
        opts = dict(isq=ISQ_TARGET, imatrix=f"{tmp}/imatrix.dat",
                    lora=f"{tmp}/lora.safetensors")
        ref_flux, ref_t5 = apply_weight_options(dense.flux_params, dense.flux_cfg,
                                                dense.t5_params, **opts)
        del dense
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with env(DIFFUSION_RS_TPU_QMM_FAST16="1"):
            pipe = Pipeline(ModelSource.from_model_id(f"{tmp}/flux"), silent=True,
                            device="cuda", **opts)._inner
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    compared = 0
    for got, want in ((pipe.flux_params, ref_flux), (pipe.t5_params, ref_t5)):
        a, b = list(_walk_qts(got)), list(_walk_qts(want))
        if len(a) != len(b) or not a:
            raise SystemExit("the loaded pipeline quantized other linears than in memory")
        for qa, qb in zip(a, b):
            for f in ("packed", "scale", "bias"):
                compared += 1
                if qa.kind != ISQ_TARGET or not torch.equal(getattr(qa, f), getattr(qb, f)):
                    raise SystemExit(f"a loaded {qa.kind} plane differs from the in-memory ISQ")
    lora = pipe.flux_params["double"]["img_attn"]["q"].lora
    want_lora = ref_flux["double"]["img_attn"]["q"].lora
    if lora is None or not all(torch.equal(x, y) for x, y in zip(lora, want_lora)):
        raise SystemExit("the loaded LoRA terms differ from the in-memory ones")
    want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), "flash_fwd": 2,
                          "qmm_affine_fast16": count_qmm_linears(pipe.flux_params)
                          + count_qmm_linears(pipe.t5_params)})
    with env(DIFFUSION_RS_TPU_QMM_FAST16="1"):
        _cuda.reset_launch_counts()
        img = pipe.forward_arrays(prompts, DiffusionGenerationParams(
            height=1024, width=1024, num_steps=1, guidance_scale=3.5, seed=7))
        counts = _cuda.launch_counts()
    print(f"isq file round trip: diffusers directory (FLUX 1+1 blocks, T5 1 layer, CLIP-L, "
          f"VAE; bf16) written in {t_write:.1f} s, loaded with isq={ISQ_TARGET!r}, an "
          f"imatrix and a LoRA in {t_load:.1f} s; {compared} planes equal to the in-memory "
          f"ISQ; 1-step image {pipe.timings['steps_s'][0] * 1e3:.1f} ms step; launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} })")
    if counts != want:
        raise SystemExit(f"isq file round trip launch counts {counts} differ from {want}")
    if img.shape != (1, 1024, 1024, 3) or img.dtype.name != "uint8":
        raise SystemExit(f"bad image: {img.dtype} {img.shape}")
    return counts["qmm_affine_fast16"]


# Depth (double, single blocks) of the images that cut it by default, to make
# room in the five-minute run for configs S and T and the serve phase; their
# widths, and so every kernel's shapes, are FLUX.1-dev's. The q8t main path,
# the serve phase, configs T, C and A keep 19 + 38; config S's images run
# EARLIER_DEPTH too, against a single-rank latent at that depth.
EARLIER_DEPTH = (3, 6)
SP = 2
# config S's latent against phase 4's (the same weights, noise and steps on
# one rank): the linears see the same rows, but the ring merges each chunk's
# bf16 attention output in f32, a change of rounding and summation order.
# Config S read 1.105e-2 at the default 4 steps on an H100 in every run so
# far (the readings are deterministic); the band is about three times that,
# so a merge that weights the chunks wrongly fails here as well as in K14's
# phase. Longer runs, whose drift is not measured, take config A's band.
# At EARLIER_DEPTH the reference is the same 3 + 6 blocks on one rank.
SP_LATENT_TOL = 3.3e-2


def sp_latent_tol(steps: int) -> float:
    return SP_LATENT_TOL if steps <= 4 else LAYOUT_LATENT_TOL
SP_INT8_ENTRIES = ("flash_s8_s8pv_lse", "flash_s8_lse", "flash_s8pv_lse")
TP = 2
# config T's latents against phase 4's (the same weights, noise and steps on
# one rank): each row-parallel linear sums two f32 partials in another order
# than one kernel's K loop, and the q8t activation quantize turns such f32
# differences into int8 code flips, as in config S; the same band.
TP_LATENT_TOL = SP_LATENT_TOL
# Config T's tiny images: (FLUX weight kind, DIFFUSION_RS_TPU_QMM_FAST16) ->
# the f32 entries each must launch (the tiny config's K-cut linears: the
# MLPs' out in FLUX, wo in T5)
TP_TINY = {"q8t": ("q8t", False, ("qmm_s8_f32", "qmm_nf4_f32")),
           "q4_0": ("q4_0", False, ("qmm_affine_f32", "qmm_nf4_f32")),
           "q4_0_fast16": ("q4_0", True, ("qmm_affine_fast16_f32", "qmm_nf4_fast16_f32"))}
# FLUX.1-dev q8t at tp=2, per forward at 1024x1024 (4096 image + 512 text
# tokens, batch 1): the K-cut linears of the 19 double blocks (img and txt
# proj and MLP out), the 38 single blocks (linear2) and the three embedders'
# out take K1's f32 entry; final.proj (N = 64, dequantized) an f32 matmul.
# One all-reduce each: 118 per forward, 48 per T5 encode (o, wo x 24).
TP_F32_LINEARS = 19 * 4 + 38 + 3
TP_ALL_REDUCES = TP_F32_LINEARS + 1
TP_FORWARD_BYTES = 4 * (19 * 2 * (4096 + 512) * 3072 + 38 * 4608 * 3072 + 3 * 3072 + 4096 * 64)
TP_T5_BYTES = 4 * 48 * 512 * 4096


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def sp_rank(rank: int, tmp: str, cfgs: dict, params: dict, tiny_params: dict, steps: int,
            prompts, t: dict) -> None:
    """Config S, one of SP ranks sharing cuda:0 over gloo (parallel.spawn).
    ``params`` are the main process's q8t weights, opened here through CUDA
    IPC (not copied); ``tiny_params`` the tiny config's, on the host. Runs
    the tiny image under the mesh, then a 1-step warm-up and the timed
    ``steps``-step 1024x1024 image (launches reset just before it and read
    just after), then one 1-step image under each int8 attention setting.
    Writes its record to ``tmp/sp_<rank>.json``; rank 0 also the latents
    and the tiny image. Then config T on the same ranks and weights
    (:func:`tp_phase` with ``t``'s configs, weights, tiny weights and
    steps)."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.parallel import make_mesh
    from diffusion_rs_tpu_torch.util.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(dp=1, sp=SP)
    rec = {"rank": rank, "device": str(mesh.device)}
    tiny = make_pipeline(tiny_configs(), tree_map(lambda t: t.cuda(), tiny_params), "cuda",
                         mesh=mesh)
    _cuda.reset_launch_counts()
    tiny_lat, tiny_img = tiny_image(tiny, tiny_inputs(tiny), "cuda")
    rec["tiny_launches"] = _nonzero(_cuda.launch_counts())
    pipe = make_pipeline(cfgs, params, "cuda", mesh=mesh)
    latents = []
    decode = pipe._decode_any

    def capture_decode(lat, h, w):
        latents.append(lat)
        return decode(lat, h, w)

    pipe._decode_any = capture_decode
    one = DiffusionGenerationParams(height=1024, width=1024, num_steps=1, guidance_scale=3.5,
                                    seed=7)
    pipe.forward_arrays(prompts, one)  # warm-up; its latent is the int8 images' reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=steps, guidance_scale=3.5, seed=7))
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _nonzero(_cuda.launch_counts())
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["timings"] = pipe.timings
    rec["image"] = [list(img.shape), str(img.dtype)]
    for entry in SP_INT8_ENTRIES:
        with attention_knobs(*LSE_ENTRIES[entry]):
            _cuda.reset_launch_counts()
            lat = pipe.forward_arrays(prompts, one, output_type="latent")
            rec[f"{entry}_launches"] = _nonzero(_cuda.launch_counts())
        rec[f"{entry}_vs_bf16"] = summed_rel(torch.from_numpy(lat), latents[0].cpu())
    with open(f"{tmp}/sp_{rank}.json", "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.save(f"{tmp}/sp_latent.npy", latents[1].float().cpu().numpy())
        np.save(f"{tmp}/tiny_latent.npy", tiny_lat.numpy())
        np.save(f"{tmp}/tiny_image.npy", tiny_img)
    del pipe, tiny, latents
    gc.collect()
    torch.cuda.empty_cache()
    tp_phase(rank, tmp, t["cfgs"], t["params"], t["tiny"], t["steps"], prompts)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_serve_rank(rank, tmp, t["cfgs"], t["params"], t["steps"])


def tp_phase(rank: int, tmp: str, cfgs: dict, params: dict, tiny_tp: dict, steps: int,
             prompts) -> None:
    """Config T, one of TP ranks sharing cuda:0 over gloo, after config S on
    the same ranks: ``make_mesh(tp=TP)``, then the tiny tp images of
    :data:`TP_TINY` (``tiny_tp``: their weights on the host), then FLUX.1-dev
    q8t and T5-XXL nf4 at full width and depth cut over tp from the main
    process's weights (CUDA IPC; each rank copies its slices): a 1-step
    256x256 warm-up and the timed ``steps``-step 1024x1024 image, with the
    launches and the all-reduces (calls and bytes,
    parallel.mesh.ALL_REDUCES) reset just before it and read just after.
    Writes ``tmp/tp_<rank>.json``; rank 0 also the timed image's latent and
    the tiny images."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda
    from diffusion_rs_tpu_torch.parallel import make_mesh
    from diffusion_rs_tpu_torch.parallel.mesh import ALL_REDUCES
    from diffusion_rs_tpu_torch.util.capacity import tree_device_bytes
    from diffusion_rs_tpu_torch.util.tree import tree_map

    mesh = make_mesh(tp=TP)
    rec = {"rank": rank, "coords": mesh.coords}
    for name, (_, fast16, _) in TP_TINY.items():
        with env(DIFFUSION_RS_TPU_QMM_FAST16="1" if fast16 else None):
            tiny = make_pipeline(tiny_configs(), tree_map(lambda t: t.cuda(), tiny_tp[name]),
                                 "cuda", mesh=mesh)
            _cuda.reset_launch_counts()
            lat, img = tiny_image(tiny, tiny_inputs(tiny), "cuda")
            rec[f"tiny_{name}_launches"] = _nonzero(_cuda.launch_counts())
        if rank == 0:
            np.save(f"{tmp}/tp_tiny_{name}_latent.npy", lat.numpy())
            np.save(f"{tmp}/tp_tiny_{name}_image.npy", img)
        del tiny
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pipe = make_pipeline(cfgs, params, "cuda", mesh=mesh)
    torch.cuda.synchronize()
    rec["cut_s"] = time.perf_counter() - t0
    rec["flux_gib"] = tree_device_bytes(pipe.flux_params) / 2**30
    rec["t5_gib"] = tree_device_bytes(pipe.t5_params) / 2**30
    rec["copied_gib"] = (torch.cuda.memory_allocated() - base) / 2**30
    latents = []
    decode = pipe._decode_any

    def capture_decode(lat, h, w):
        latents.append(lat)
        return decode(lat, h, w)

    pipe._decode_any = capture_decode
    # warm-up at 256x256: every kernel and all-reduce of the path at a
    # sixth of the full size's gloo traffic (768 rows a linear, not 4608)
    pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=256, width=256, num_steps=1, guidance_scale=3.5, seed=7))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    ALL_REDUCES.clear()
    t0 = time.perf_counter()
    img = pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=steps, guidance_scale=3.5, seed=7))
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _nonzero(_cuda.launch_counts())
    rec["all_reduces"] = dict(ALL_REDUCES)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["timings"] = pipe.timings
    rec["image"] = [list(img.shape), str(img.dtype)]
    with open(f"{tmp}/tp_{rank}.json", "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.save(f"{tmp}/tp_latent.npy", latents[-1].float().cpu().numpy())


# The mesh serve's requests (prompt, seed): three lanes at max_batch 2 over
# dp=2, so the first two share a bucket of 2 (one lane a rank) and the third
# runs alone in the smallest bucket, dp (its padding lane on the other rank).
MESH_SERVE_REQUESTS = tuple(
    (p, seed) for p, seed, edit in SERVE_REQUESTS[:3])
MESH_SERVE_DP, MESH_SERVE_MAX_BATCH = 2, 2


def mesh_serve_rank(rank: int, tmp: str, cfgs: dict, params: dict, steps: int) -> None:
    """The mesh serve, one of the two ranks after config T: a ``make_mesh(dp=2)``
    pipeline on the main process's q8t weights (CUDA IPC, uncut) and
    ``FluxServer(max_batch=2)`` on every rank; rank 0 submits
    MESH_SERVE_REQUESTS at ``steps`` steps, the other follows the command
    stream. Launches are reset before the server is built and read once
    this rank's server has stopped; K1's tallied by M and K3's by B. Writes
    ``tmp/serve_<rank>.json`` and, on rank 0, the images."""
    import numpy as np
    import torch

    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.ops import _cuda, flash, qmatmul
    from diffusion_rs_tpu_torch.parallel import make_mesh
    from diffusion_rs_tpu_torch.serving import FluxServer

    mesh = make_mesh(dp=MESH_SERVE_DP)
    pipe = make_pipeline(cfgs, params, "cuda", mesh=mesh)
    shapes = {"qmm_s8": collections.Counter(), "flash_fwd": collections.Counter()}
    k1, k3 = qmatmul.qmm_s8, flash.flash_fwd

    def k1_tally(x2, qt, out_dtype):
        shapes["qmm_s8"][f"M{x2.shape[0]}"] += 1
        return k1(x2, qt, out_dtype)

    def k3_tally(q, *a, **kw):
        shapes["flash_fwd"][f"B{q.shape[0]}"] += 1
        return k3(q, *a, **kw)

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    qmatmul.qmm_s8, flash.flash_fwd = k1_tally, k3_tally
    # a long poll: the three requests are queued before the first admission
    server = FluxServer(pipe, max_batch=MESH_SERVE_MAX_BATCH, poll_ms=500.0)
    rec = {"rank": rank, "leader": server.leader}
    try:
        if server.leader:
            t0 = time.perf_counter()
            futs = [server.submit(p, DiffusionGenerationParams(
                height=1024, width=1024, num_steps=steps, guidance_scale=3.5, seed=seed))
                for p, seed in MESH_SERVE_REQUESTS]
            images = [f.result(timeout=600) for f in futs]
            rec["served_s"] = time.perf_counter() - t0
            rec["stats"] = server.stats()
            np.save(f"{tmp}/mesh_serve_images.npy", np.stack(images))
    finally:
        server.shutdown()
        qmatmul.qmm_s8, flash.flash_fwd = k1, k3
    torch.cuda.synchronize()
    rec["launches"] = _nonzero(_cuda.launch_counts())
    rec["shapes"] = {k: dict(v) for k, v in shapes.items()}
    with open(f"{tmp}/serve_{rank}.json", "w") as f:
        json.dump(rec, f)


def check_mesh_serve(tmp: str, refs, steps: int) -> dict:
    """The mesh serve's checks: each served image within the serve phase's
    band of the single-process pipeline's image for the same seed and steps
    (``refs``); the stats (forwards, lane steps, padding: buckets of dp);
    each rank's launches exact (K1 503 and K3 57 a forward, K2 168 an
    encode: every rank encodes every prompt), every K3 launch at the
    dp-local batch B1 and K1 at its rows (M 4608 for the single blocks).
    Returns rank 0's K1 and K3 launches."""
    import numpy as np

    recs = []
    for r in range(MESH_SERVE_DP):
        with open(f"{tmp}/serve_{r}.json") as f:
            recs.append(json.load(f))
    images = np.load(f"{tmp}/mesh_serve_images.npy")
    n = len(MESH_SERVE_REQUESTS)
    stats = recs[0]["stats"]
    forwards = 2 * steps  # the pair's bucket, then the lone lane's
    want_stats = (forwards, n * steps, steps, n, 0)
    got_stats = tuple(stats[k] for k in ("forwards", "lane_steps", "padded_lane_steps",
                                         "completed", "failed"))
    want = with_prologue({"qmm_s8": 503 * forwards, "flash_fwd": 57 * forwards,
                          "qmm_nf4": 168 * n})
    bands = []
    for got, ref in zip(images, refs):
        d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
        bands.append((float(d.mean()), float(d.max())))
    print(f"mesh serve (FluxServer on make_mesh(dp={MESH_SERVE_DP}), two ranks sharing the "
          f"card over gloo: not a multi-GPU figure): {n} requests at 1024x1024, {steps} "
          f"steps, max_batch {MESH_SERVE_MAX_BATCH}, served in {recs[0]['served_s']:.3f} s, "
          f"{recs[0]['served_s'] / n:.3f} s per image; stats (forwards, lane steps, padded, "
          f"completed, failed) {got_stats} (expected {want_stats})")
    print("mesh serve lanes vs the single-process images (u8 mean |diff|, max): "
          + ", ".join(f"{m:.4f} / {x:.0f}" for m, x in bands))
    for r in recs:
        print(f"mesh serve rank {r['rank']} ({'leader' if r['leader'] else 'follower'}): "
              f"launches {r['launches']} (expected {want}); by shape {json.dumps(r['shapes'])}")
        if r["launches"] != want:
            raise SystemExit(f"mesh serve rank {r['rank']}: launches {r['launches']}, "
                             f"expected {want}")
        if set(r["shapes"]["flash_fwd"]) != {"B1"} or "M4608" not in r["shapes"]["qmm_s8"]:
            raise SystemExit(f"mesh serve rank {r['rank']} did not run the dp-local batch: "
                             f"{r['shapes']}")
    if got_stats != want_stats:
        raise SystemExit(f"mesh serve stats {stats}: expected {want_stats}")
    bad = [i for i, (m, x) in enumerate(bands)
           if not (m < SERVE_MEAN_BAND and x <= SERVE_MAX_BAND)]
    if bad or images.shape != (n, 1024, 1024, 3):
        raise SystemExit(f"mesh serve lanes {bad} outside the band of the single-process "
                         f"images: {bands}")
    return recs[0]["launches"]


# The dryrun's world: JAX's default n, each rank on the one card over gloo.
DRYRUN_N = 8
# Its phase 2 per rank (one q8t forward of the tiny config at dp=2 sp=2
# tp=2: hidden 128, 4 heads, 2 a rank): K1 on img_in, txt_in, the three
# embedders' out (K=128 kept whole: a K-cut would split its 128-row scale
# group), every modulation (2 x 2 double, 4 single, final), the double
# blocks' proj (kept whole) and MLP in (N 256 a rank), the single blocks'
# proj_mlp: 2 + 3 + 9 + 2 x 2 x 2 + 4 = 26; K1's f32 entry on the double
# blocks' MLP out (K-cut to 256 rows): 2 x 2 = 4. The q/k/v (64 columns a
# rank), the embedders' in, linear2 (K 640) and final.proj (N 64) take
# dequantize + matmul. K14 on each joint attention's two ring chunks: 6 x 2.
DRYRUN_Q8T_LAUNCHES = {"qmm_s8": 26, "qmm_s8_f32": 4, "flash_fwd_lse": 12}


def dryrun_rank(rank: int, tmp: str) -> None:
    """One rank of the dryrun world: ``dryrun_multichip(DRYRUN_N)`` on the
    spawned group (it asserts its own checks); writes its record to
    ``tmp/dryrun_<rank>.json``."""
    from diffusion_rs_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    rec = dryrun_multichip(DRYRUN_N)
    rec["run_s"] = time.perf_counter() - t0
    with open(f"{tmp}/dryrun_{rank}.json", "w") as f:
        json.dump(rec, f)


def dryrun_phase() -> dict:
    """The training dryrun (diffusion_rs_tpu_torch/dryrun.py) on DRYRUN_N
    ranks spawned on the card over gloo: phase 1's loss finite and the same
    on every rank, no kernel launched by the training step, every tp-cut
    leaf's gradient nonzero; phase 2's launches per rank exact
    (DRYRUN_Q8T_LAUNCHES) and its ring's hops (6 joint attentions x (sp -
    1)). Prints the spawn and run times. Returns rank 0's phase-2
    launches."""
    import tempfile

    from diffusion_rs_tpu_torch.parallel import spawn

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(dryrun_rank, DRYRUN_N, "gloo", args=(tmp,))
        wall = time.perf_counter() - t0
        recs = []
        for r in range(DRYRUN_N):
            with open(f"{tmp}/dryrun_{r}.json") as f:
                recs.append(json.load(f))
    run = max(r["run_s"] for r in recs)
    losses = {r["loss"] for r in recs}
    print(f"dryrun_multichip({DRYRUN_N}): {DRYRUN_N} ranks on the one card over gloo in "
          f"{wall:.1f} s (spawn, start-up and both phases; the phases {run:.2f} s on the "
          f"slowest rank); mesh {recs[0]['mesh']}, heads {recs[0]['heads']}, batch "
          f"{recs[0]['batch']}; loss {sorted(losses)}; training-step launches "
          f"{[r['train_launches'] for r in recs]}; tp-cut leaves with a nonzero gradient "
          f"{[r['tp_cut_leaves'] for r in recs]} (zero: "
          f"{sum(len(r['zero_grad_leaves']) for r in recs)}); phase 2 launches per rank "
          f"{[r['q8t_launches'] for r in recs]} (expected {DRYRUN_Q8T_LAUNCHES}), ring hops "
          f"{[r['ring_hops'] for r in recs]}")
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"dryrun losses {losses}: expected one finite value")
    for r in recs:
        if r["train_launches"] or r["zero_grad_leaves"] or not r["tp_cut_leaves"]:
            raise SystemExit(f"dryrun rank: training launches {r['train_launches']}, zero "
                             f"gradients {r['zero_grad_leaves']}")
        if r["q8t_launches"] != DRYRUN_Q8T_LAUNCHES or r["ring_hops"] != 6:
            raise SystemExit(f"dryrun phase 2: launches {r['q8t_launches']}, hops "
                             f"{r['ring_hops']}; expected {DRYRUN_Q8T_LAUNCHES}, 6")
    return recs[0]["q8t_launches"]


def grad_guard_check() -> None:
    """The kernels have no backward: one q8t linear (K1) and one flash call
    (K3) on inputs that require grad, under grad mode, must raise
    RuntimeError and launch nothing."""
    import torch

    from diffusion_rs_tpu_torch.ops import Linear, _cuda, linear
    from diffusion_rs_tpu_torch.ops.attention import sdpa
    from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

    gen = torch.Generator(device="cuda").manual_seed(5)
    lin = Linear(w=random_qtensor(gen, 3072, 3072, kind="q8t", device="cuda"))
    x = torch.randn((64, 3072), generator=gen, device="cuda").bfloat16().requires_grad_(True)
    q = torch.randn((1, 24, 256, 128), generator=gen, device="cuda").bfloat16()
    q.requires_grad_(True)
    before = _cuda.launch_counts()
    raised = []
    for name, fn in (("q8t linear", lambda: linear(x, lin)), ("flash", lambda: sdpa(q, q, q))):
        try:
            fn()
        except RuntimeError as e:
            raised.append(f"{name}: {str(e)[:60]}...")
    print(f"grad guard: {len(raised)} of 2 calls on inputs that require grad raised "
          f"({'; '.join(raised)}); launches unchanged {_cuda.launch_counts() == before}")
    if len(raised) != 2 or _cuda.launch_counts() != before:
        raise SystemExit("grad guard: a kernel ran on an input that requires grad")


def single_rank_latent(cfgs: dict, params: dict, prompts, steps: int):
    """The packed latent of one rank's ``steps``-step 1024x1024 image on
    ``params`` (seed 7, guidance 3.5, as every timed image here)."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams

    pipe = make_pipeline(cfgs, params, "cuda")
    captured = {}
    denoise = pipe._denoise
    pipe._denoise = lambda *a: captured.setdefault("latent", denoise(*a))
    pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=steps, guidance_scale=3.5, seed=7),
        output_type="latent")
    return captured["latent"]


def cut_depth(cfgs: dict, params: dict, depth) -> tuple:
    """FLUX cut to its first ``depth`` (double, single) blocks: the config
    and views of the stacked block weights."""
    from diffusion_rs_tpu_torch.util.tree import tree_map

    flux = params["flux_params"]
    return ({**cfgs, "flux_cfg": dataclasses.replace(
                cfgs["flux_cfg"], num_layers=depth[0], num_single_layers=depth[1])},
            {**params, "flux_params": {**flux,
                                       "double": tree_map(lambda t: t[:depth[0]], flux["double"]),
                                       "single": tree_map(lambda t: t[:depth[1]], flux["single"])}})


def config_s(cfgs: dict, pipe, prompts, steps: int, ref_latent, full_depth: bool) -> dict:
    """Config S: FLUX.1-dev q8t at full width, 1024x1024, batch 1,
    sequence-parallel over SP ranks that share the one card (gloo moves k/v
    through pinned host memory: not a multi-GPU figure), at EARLIER_DEPTH
    unless ``full_depth``. The ranks open the main pipeline's weights
    through CUDA IPC. Checks: the tiny sp image against the CPU's plain
    versions, exact launches per rank (K14 on every attention call, K3
    never), the latent against one rank's at the same depth (phase 4's at
    full depth), and each int8 setting's 1-step latent against the bf16
    one. Then config T on the same ranks at full depth, its timed image
    ``min(steps, 2)`` steps against one rank's (:func:`check_config_t`).
    Returns rank 0's K14 launches and config
    T's f32-entry launches."""
    import tempfile

    import numpy as np
    import torch

    from diffusion_rs_tpu_torch.parallel import spawn

    tiny_cfgs = tiny_configs()
    tiny_params = make_params(tiny_cfgs, seed=11, device="cpu")
    cpu = make_pipeline(tiny_cfgs, tiny_params, device="cpu")
    tiny_cpu = tiny_image(cpu, tiny_inputs(cpu), "cpu")
    # config T's tiny weights and their single-process CPU images (the q8t
    # one is config S's)
    tiny_tp, tiny_tp_cpu = {}, {}
    for name, (kind, fast16, _) in TP_TINY.items():
        tiny_tp[name] = tiny_params if kind == "q8t" else make_params(
            tiny_cfgs, seed=11, device="cpu", flux_kind=kind)
        with env(DIFFUSION_RS_TPU_QMM_FAST16="1" if fast16 else None):
            ref = make_pipeline(tiny_cfgs, tiny_tp[name], device="cpu")
            tiny_tp_cpu[name] = tiny_cpu if kind == "q8t" and not fast16 else tiny_image(
                ref, tiny_inputs(ref), "cpu")
    params = {k: getattr(pipe, k) for k in ("flux_params", "t5_params", "clip_params",
                                            "vae_params")}
    s_cfgs, s_params = (cfgs, params) if full_depth else cut_depth(cfgs, params, EARLIER_DEPTH)
    s_ref = ref_latent if full_depth else single_rank_latent(s_cfgs, s_params, prompts, steps)
    t_steps = min(steps, 2)
    t_ref = ref_latent if t_steps == steps else single_rank_latent(cfgs, params, prompts,
                                                                     t_steps)
    t = {"cfgs": cfgs, "params": params, "tiny": tiny_tp, "steps": t_steps}
    # the mesh serve's references: this process's pipeline, one request at a time
    from diffusion_rs_tpu_torch import DiffusionGenerationParams

    serve_refs = [pipe.forward_arrays([p], DiffusionGenerationParams(
        height=1024, width=1024, num_steps=t_steps, guidance_scale=3.5, seed=seed))[0]
        for p, seed in MESH_SERVE_REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(sp_rank, SP, "gloo", args=(tmp, s_cfgs, s_params, tiny_params, steps, prompts, t))
        wall = time.perf_counter() - t0
        t_counts = check_config_t(tmp, tiny_tp_cpu, t_steps, t_ref)
        check_mesh_serve(tmp, serve_refs, t_steps)
        recs = []
        for r in range(SP):
            with open(f"{tmp}/sp_{r}.json") as f:
                recs.append(json.load(f))
        lat = torch.from_numpy(np.load(f"{tmp}/sp_latent.npy"))
        tiny_card = (torch.from_numpy(np.load(f"{tmp}/tiny_latent.npy")),
                     np.load(f"{tmp}/tiny_image.npy"))
    lat_err, psnr = image_match(tiny_card, tiny_cpu)
    print(f"config S tiny reference (sp={SP} on the card vs one CPU process): latent summed-rel "
          f"{lat_err:.3e}, image PSNR {psnr:.1f} dB; card launches per rank "
          f"{[r['tiny_launches'] for r in recs]}")
    if not (lat_err <= 2e-2 and psnr >= 30.0):
        raise SystemExit("config S tiny check failed: the sp image on the card does not agree "
                         "with the plain versions on the CPU")
    for r in recs:
        c = r["tiny_launches"]
        if not (c.get("flash_fwd_lse") and c.get("qmm_s8") and not c.get("flash_fwd")):
            raise SystemExit(f"config S tiny image did not run the ring's kernels: {c}")
    hop_mb = 2 * 24 * (4096 + 512) // SP * 128 * 2 / 1e6  # k and v of one rank's rows, bf16
    per_step = flux_launches(s_cfgs["flux_cfg"])
    attn = per_step["attention"]
    want = with_prologue({"qmm_s8": per_step["diffusers"] * steps, "qmm_nf4": 168,
                          "flash_fwd_lse": attn * SP * steps})
    for r in recs:
        tm = r["timings"]
        steps_ms = [x * 1e3 for x in tm["steps_s"]]
        print(f"config S rank {r['rank']} on {r['device']} image {r['wall_s']:.3f} s: encode "
              f"{tm['encode_s'] * 1e3:.1f} ms, step median {statistics.median(steps_ms):.2f} ms "
              f"({min(steps_ms):.1f}-{max(steps_ms):.1f}), steps ms "
              f"{[round(x, 1) for x in steps_ms]}, decode {tm['decode_s'] * 1e3:.1f} ms, peak "
              f"memory {r['peak_gib']:.2f} GiB (activations; the weights are the main "
              f"process's, through CUDA IPC); {SP - 1} hops of {hop_mb:.1f} MB (k and v) per "
              f"attention call, {attn * (SP - 1)} per step; launches {r['launches']} (expected "
              f"{want}, every other kernel 0)")
        if r["launches"] != want:
            raise SystemExit(f"config S rank {r['rank']} launches {r['launches']} differ "
                             f"from {want}")
        if r["image"] != [[1, 1024, 1024, 3], "uint8"]:
            raise SystemExit(f"config S rank {r['rank']}: bad image {r['image']}")
        for entry in SP_INT8_ENTRIES:
            w = with_prologue({"qmm_s8": per_step["diffusers"], "qmm_nf4": 168,
                               entry: attn * SP, "flash_quant": attn * SP})
            got, dist = r[f"{entry}_launches"], r[f"{entry}_vs_bf16"]
            print(f"config S rank {r['rank']}, {entry} (1-step image): launches {got}, latent "
                  f"vs the bf16 1-step latent summed-rel {dist:.3e} (band {INT8_LATENT_TOL:g})")
            if got != w or not dist <= INT8_LATENT_TOL:
                raise SystemExit(f"config S {entry}: launches {got} (expected {w}), latent "
                                 f"{dist:.3e} from bf16's")
    dist = summed_rel(lat, s_ref.float().cpu())
    depth = (s_cfgs["flux_cfg"].num_layers, s_cfgs["flux_cfg"].num_single_layers)
    print(f"config S ({depth[0]} + {depth[1]} blocks): {SP} ranks and config T in {wall:.1f} s "
          f"(spawn and set-up included); latent vs one rank's q8t latent at that depth: "
          f"summed-rel {dist:.3e} (band {sp_latent_tol(steps):g})")
    if tuple(lat.shape) != (1, 4096, 64) or not torch.isfinite(lat).all() \
            or not dist <= sp_latent_tol(steps):
        raise SystemExit(f"config S latent: shape {tuple(lat.shape)}, {dist:.3e} from phase 4's")
    return {"flash_fwd_lse": recs[0]["launches"]["flash_fwd_lse"],
            **{e: recs[0][f"{e}_launches"][e] for e in SP_INT8_ENTRIES}, **t_counts}


def check_config_t(tmp: str, tiny_cpu: dict, steps: int, ref_latent) -> dict:
    """Config T's checks on the ranks' records: each tiny tp image against
    the same image on the CPU in one process (plain versions) and its f32
    entries launched; the full-width image's exact launches per rank (K1's
    f32 entry on the K-cut linears, 117 per forward; K2's on T5's o and wo,
    48; K3 on 12 heads, 57 per step), its all-reduces (118 per forward and
    48 per T5 encode, calls and bytes), and its ``steps``-step latent
    against one rank's (``ref_latent``). Returns rank 0's f32-entry launches (the
    q8t image's, and the tiny images' of the others)."""
    import numpy as np
    import torch

    recs = []
    for r in range(TP):
        with open(f"{tmp}/tp_{r}.json") as f:
            recs.append(json.load(f))
    counts = {}
    for name, (_, _, entries) in TP_TINY.items():
        card = (torch.from_numpy(np.load(f"{tmp}/tp_tiny_{name}_latent.npy")),
                np.load(f"{tmp}/tp_tiny_{name}_image.npy"))
        lat_err, psnr = image_match(card, tiny_cpu[name])
        got = [r[f"tiny_{name}_launches"] for r in recs]
        print(f"config T tiny {name} (tp={TP} on the card vs one CPU process): latent "
              f"summed-rel {lat_err:.3e}, image PSNR {psnr:.1f} dB; card launches per rank {got}")
        if not (lat_err <= 2e-2 and psnr >= 30.0):
            raise SystemExit(f"config T tiny {name}: the tp image on the card does not agree "
                             "with the plain versions on the CPU")
        if not all(c.get(e) for c in got for e in entries):
            raise SystemExit(f"config T tiny {name} did not launch {entries}: {got}")
        counts.update({e: got[0][e] for e in entries if e not in ("qmm_s8_f32", "qmm_nf4_f32")})
    want = with_prologue({"qmm_s8": (503 - TP_F32_LINEARS) * steps,
                          "qmm_s8_f32": TP_F32_LINEARS * steps, "qmm_nf4": 168 - 48,
                          "qmm_nf4_f32": 48, "flash_fwd": 57 * steps})
    want_ar = {"calls": TP_ALL_REDUCES * steps + 48,
               "bytes": TP_FORWARD_BYTES * steps + TP_T5_BYTES}
    for r in recs:
        tm = r["timings"]
        steps_ms = [x * 1e3 for x in tm["steps_s"]]
        ar = r["all_reduces"]
        print(f"config T rank {r['rank']} (tp {r['coords']['tp']}): its cut {r['flux_gib']:.2f} "
              f"GiB FLUX + {r['t5_gib']:.2f} GiB T5 ({r['copied_gib']:.2f} GiB copied in "
              f"{r['cut_s']:.3f} s); image {r['wall_s']:.3f} s: encode {tm['encode_s'] * 1e3:.1f} "
              f"ms, step median {statistics.median(steps_ms):.2f} ms ({min(steps_ms):.1f}-"
              f"{max(steps_ms):.1f}), decode {tm['decode_s'] * 1e3:.1f} ms, peak memory "
              f"{r['peak_gib']:.2f} GiB; all-reduces {ar.get('calls', 0)} of "
              f"{ar.get('bytes', 0) / 1e9:.3f} GB (expected {want_ar['calls']} of "
              f"{want_ar['bytes'] / 1e9:.3f}: {TP_ALL_REDUCES} a forward, 48 a T5 encode; gloo "
              f"through pinned host memory); launches {r['launches']} (expected {want})")
        if r["launches"] != want or ar != want_ar:
            raise SystemExit(f"config T rank {r['rank']}: launches {r['launches']}, all-reduces "
                             f"{ar}; expected {want}, {want_ar}")
        if r["image"] != [[1, 1024, 1024, 3], "uint8"]:
            raise SystemExit(f"config T rank {r['rank']}: bad image {r['image']}")
    lat = torch.from_numpy(np.load(f"{tmp}/tp_latent.npy"))
    dist = summed_rel(lat, ref_latent.float().cpu())
    tol = TP_LATENT_TOL if steps <= 4 else LAYOUT_LATENT_TOL
    print(f"config T {steps}-step latent vs one rank's q8t latent: summed-rel {dist:.3e} "
          f"(band {tol:g})")
    if tuple(lat.shape) != (1, 4096, 64) or not torch.isfinite(lat).all() or not dist <= tol:
        raise SystemExit(f"config T {steps}-step latent: shape {tuple(lat.shape)}, {dist:.3e} "
                         "from one rank's")
    counts.update(qmm_s8_f32=recs[0]["launches"]["qmm_s8_f32"],
                  qmm_nf4_f32=recs[0]["launches"]["qmm_nf4_f32"])
    return counts


def tiled_decode(pipe) -> None:
    """One 720x1280 decode (latent 90x160, above the 128-pixel threshold:
    two tiles of DIFFUSION_RS_TPU_VAE_TILE's default 128) through the
    pipeline's decode seam, timed after a warm-up; peak memory above what
    was allocated before it."""
    import torch

    from diffusion_rs_tpu_torch.models import vae

    gen = torch.Generator(device="cuda").manual_seed(9)
    lat = torch.randn((1, 45 * 80, 64), generator=gen, device="cuda")
    tiles = []
    decode_tile = vae._decode_tile
    vae._decode_tile = lambda p, c, z: tiles.append(tuple(z.shape)) or decode_tile(p, c, z)
    try:
        pipe._decode_any(lat, 720, 1280)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = pipe._decode_any(lat, 720, 1280)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        vae._decode_tile = decode_tile
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"tiled decode 720x1280 (latent 90x160): {ms:.1f} ms, peak {peak:.2f} GiB above the "
          f"resident weights, tiles {tiles[len(tiles) // 2:]}")
    if tuple(img.shape) != (1, 720, 1280, 3) or img.dtype != torch.uint8 or len(tiles) != 4:
        raise SystemExit(f"bad tiled decode: {tuple(img.shape)} {img.dtype}, tiles {tiles}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="denoise steps of the timed image")
    ap.add_argument("--full-depth", action="store_true",
                    help="run the GGUF, B, D0/D/F, dense, E0/E and config S images at "
                         f"FLUX.1-dev's 19 + 38 blocks (default: {EARLIER_DEPTH[0]} + "
                         f"{EARLIER_DEPTH[1]}, the same widths)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from diffusion_rs_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    mem = host_memory()
    link = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,"
         "pcie.link.gen.max,pcie.link.width.max", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(f"host memory: MemTotal {mem['MemTotal'] / 2**30:.2f} GiB, MemAvailable "
          f"{mem['MemAvailable'] / 2**30:.2f} GiB; PCIe link (gen, width current; gen, width "
          f"max): {link.stdout.strip() if link.returncode == 0 else 'not available'}")

    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {phase} done")

    t0 = time.perf_counter()
    times = _cuda.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s: " +
          ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in _cuda.SOURCES:
        _cuda.library(name)
    print("SASS " + check_sass())

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {
        "qmm_s8": [check_qmm("q8t", 1, 3072, 3072, gen, K1_TOL),
                   check_qmm("q8t", 4096, 3072, 3072, gen, K1_TOL)],
        "qmm_nf4": [check_qmm("nf4", 512, 4096, 4096, gen, K2_TOL),
                    check_qmm("nf4", 512, 10240, 4096, gen, K2_TOL),
                    check_qmm("nf4", 4608, 3072, 12288, gen, K2_TOL)],  # configs D0/D
        "qmm_affine": [check_qmm(kind, m, 3072, n, gen, K4_TOL)
                       for kind in GGUF_KINDS for m, n in ((1, 18432), (4608, 21504))],
        # config T's 12 heads a rank last
        "flash_fwd": [check_flash(4608, gen), check_flash(4112, gen),
                      check_flash(4608, gen, h=24 // TP)],
        "flash_sm": [check_flash_seqmajor(s_, gen, rope=False) for s_ in (4608, 4112)],
        "flash_rope": [check_flash_seqmajor(s_, gen, rope=True) for s_ in (4608, 4112)],
        "rope_qk": [check_rope_qk(s_, gen) for s_ in (4608, 4112)],
        "qk_norm_rope": [check_qk_norm_rope(kind) for kind in ("double", "single")],
        "qmm_grouped_s8": check_grouped("q8t", gen),
        "qmm_grouped_affine": check_grouped("q8_0", gen) + check_grouped("q4_0", gen),
        **{entry: [check_flash_int8(s_, gen, entry) for s_ in (4608, 4112, 2304)]
           for entry in INT8_MODES},
        "flash_quant": [check_flash_quant(s_, gen) for s_ in (4608, 4112, 2304)],
        # K14 at config S's shape (each rank's 2304 rows), the main path's and
        # a ragged one
        **{entry: [check_flash_lse(s_, gen, entry) for s_ in (2304, 4608, 4112)]
           for entry in LSE_ENTRIES},
        "qmm_grouped_nf4": check_grouped("nf4", gen),
        # K12 / K13, each beside its f32-decode kernel (K2 / K4) in this run
        "qmm_nf4_fast16": [check_fast16("nf4", 512, 10240, 4096, gen),
                           check_fast16("nf4", 4608, 3072, 12288, gen)],  # config F
        "qmm_affine_fast16": [check_fast16("q4_0", 4608, 3072, 21504, gen),
                              check_fast16("q4_k", 4608, 3072, 21504, gen)],  # config E
        # the f32 entries at config T's K-slices (tp=2): proj, linear2, T5's wo
        "qmm_s8_f32": [check_qmm_f32("qmm_s8", 4096, 1536, 3072, gen),
                       check_qmm_f32("qmm_s8", 4608, 7680, 3072, gen)],
        "qmm_nf4_f32": [check_qmm_f32("qmm_nf4", 512, 5120, 4096, gen)],
        "qmm_nf4_fast16_f32": [check_qmm_f32("qmm_nf4_fast16", 512, 5120, 4096, gen)],
        "qmm_affine_f32": [check_qmm_f32("qmm_affine", 4608, 7680, 3072, gen)],
        "qmm_affine_fast16_f32": [check_qmm_f32("qmm_affine_fast16", 4608, 7680, 3072, gen)],
    }
    for name, rows in checks.items():
        for r in rows:
            extra = "".join(f", {key} {r[key]:.3e}" for key in (
                "vs_k6_max_abs", "vs_single_max_abs", "decoded_max_abs", "vs_f32_decode",
                "lse_max_abs", "mean_max_abs", "scale_ulps", "codes_off") if key in r)
            err = f"summed-rel {r['summed_rel']:.3e} " if "summed_rel" in r else ""
            line = f"kernel {name} {r['shape']}: {err}max-abs {r['max_abs_err']:.3e}{extra}"
            if "ms" in r:
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
                line += (f" | kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                         f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}")
            if "rope_ms" in r:
                line += f"; the rotation pass alone {r['rope_ms']:.4f} ms"
            if "device_ms" in r:
                line += f"; device time {r['device_ms']:.4f} ms (profiler)"
            if "library_note" in r:
                line += f" ({r['library_note']})"
            if "wrapper_ms" in r:
                via = "quantize_kv" if name == "flash_quant" else "its wrapper, back to back"
                line += f"; through {via} {r['wrapper_ms']:.4f} ms"
            if "design_bound_ms" in r:
                line += f"; design bound {r['design_bound_ms']:.4f} ms"
            if "with_prepass_ms" in r:
                line += f"; with the prepass kernel {r['with_prepass_ms']:.4f} ms"
            if "per_group_ms" in r:
                line += f" (two calls), per-group launches {r['per_group_ms']:.4f} ms"
            if "f32_decode_ms" in r:
                line += f"; the f32-decode kernel on the same weights {r['f32_decode_ms']:.4f} ms"
            if "bf16_entry_ms" in r:
                line += f"; the bf16 entry on the same weights {r['bf16_entry_ms']:.4f} ms"
            if "pass1_ms" in r:
                i8 = r["int8_gemm_ms"]
                line += (f"; pass 1 (quantize) {r['pass1_ms']:.4f} ms, pass 2 (product) "
                         f"{r['pass2_ms']:.4f} ms (profiler); int8 GEMM alone, not the library "
                         "row: torch._int_mm " + ("n/a" if i8 is None else
                                                  f"{i8['row_major_ms']:.4f} ms on the [K, N] "
                                                  f"plane, {i8['col_major_ms']:.4f} ms on a "
                                                  "column-major copy"))
            print(line)
    k4_formats = [check_affine_format(fmt, 33, 3072, 3072, gen)
                  for fmt in ("q6_k", "q4_k", "int8")]
    for r in k4_formats:
        print(f"kernel qmm_affine {r['shape']}: summed-rel {r['summed_rel']:.3e} "
              f"max-abs {r['max_abs_err']:.3e} (untimed)")
    fast16_formats = [check_fast16_format(fmt, 33, 3072, 3072, gen)
                      for fmt in ("q8_0", "q6_k", "int8", "q4_k_zero_scales")]
    for r in fast16_formats:
        print(f"kernel qmm_affine_fast16 {r['shape']}: decoded max-abs "
              f"{r['decoded_max_abs']:.3e}, summed-rel {r['summed_rel']:.3e} max-abs "
              f"{r['max_abs_err']:.3e} (untimed)")
    grad_guard_check()
    mark("kernel phase")
    for attn_layout in (None, "inkernel", "seqmajor"):
        tiny_reference_check(attn_layout)
    tiny_reference_check(int8=True)
    tiny_reference_check(flux_kind="nf4", fuse="grouped")
    tiny_reference_check(isq=True)
    tiny_edit_check("img2img")
    tiny_edit_check("inpaint")
    mark("tiny references")

    # -- the full-width main path ---------------------------------------------
    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig

    cfgs = dict(flux_cfg=FluxConfig(), t5_cfg=T5Config(), clip_cfg=ClipTextConfig(),
                vae_cfg=VAEConfig())
    t0 = time.perf_counter()
    pipe = make_pipeline(cfgs, make_params(cfgs, seed=0, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    print(f"synthetic full-size weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    captured = {}
    denoise_stage = pipe._denoise

    def capture_denoise(*a):
        captured["latent"] = denoise_stage(*a)
        return captured["latent"]

    pipe._denoise = capture_denoise
    prompts = ["a photo of a cat sitting on a wooden table"]
    t0 = time.perf_counter()
    pipe.forward_arrays(prompts, DiffusionGenerationParams(
        height=1024, width=1024, num_steps=1, guidance_scale=3.5, seed=7))
    print(f"warm-up image (1 step) in {time.perf_counter() - t0:.1f} s")

    params = DiffusionGenerationParams(height=1024, width=1024, num_steps=args.steps,
                                       guidance_scale=3.5, seed=7)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    before = card_state()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.forward_arrays(prompts, params)
    wall = time.perf_counter() - t0
    print(f"card (SM clock, max, power, temperature, throttle reasons) before: {before}; "
          f"after: {card_state()}")
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = pipe.timings
    want = with_prologue({**dict.fromkeys(_cuda.KERNELS, 0), "qmm_s8": 503 * args.steps,
                          "qmm_nf4": 168, "flash_fwd": 57 * args.steps})
    print(f"image {wall:.3f} s: encode {tm['encode_s'] * 1e3:.1f} ms, steps ms "
          f"{[round(s * 1e3, 1) for s in tm['steps_s']]}, decode "
          f"{tm['decode_s'] * 1e3:.1f} ms, peak memory {peak:.2f} GiB "
          f"({capacity_estimate(pipe)})")
    print(f"launches { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }, every other kernel 0)")
    lat = captured["latent"]
    if counts != want:
        raise SystemExit(f"launch counts {counts} differ from the main path's {want}")
    if img.shape != (1, 1024, 1024, 3) or img.dtype.name != "uint8":
        raise SystemExit(f"bad image: {img.dtype} {img.shape}")
    if tuple(lat.shape) != (1, 4096, 64) or not torch.isfinite(lat).all():
        raise SystemExit(f"bad latent: {tuple(lat.shape)}, finite "
                         f"{bool(torch.isfinite(lat).all())}")

    profile_image(pipe, prompts)
    mark("main path")
    serve_rows = serve_phase(pipe, args.steps, img[0])
    mark("serve phase")
    small_entry_points()
    mark("serve_http, trace")
    image_edit_phase(pipe, prompts, args.steps, img[0], lat)
    mark("img2img / inpaint")

    # -- phases 4c / 4d: Offloading.Full and Offloading.Stream on phase 4's
    # weights, each held to phase 4's latent and launches
    ref = {"latent": lat, "peak": peak, "weights": weights,
           "step_ms": statistics.median(s * 1e3 for s in tm["steps_s"])}
    full_offload_phase(cfgs, pipe, prompts, args.steps, want, ref)
    gc.collect()  # the registry's pinned pages go back before phase 4d
    mark("Offloading.Full")
    stream_phase(cfgs, pipe, prompts, args.steps, want, ref)
    gc.collect()
    print(f"host memory after phases 4c / 4d: MemAvailable "
          f"{host_memory()['MemAvailable'] / 2**30:.2f} GiB, the process's VmRSS "
          f"{process_rss() / 2**30:.2f} GiB")
    mark("Offloading.Stream")

    # -- the GGUF paths: encoders shared with the q8t pipeline ----------------
    encoders = {"cfgs": {k: v for k, v in cfgs.items() if k != "flux_cfg"},
                "params": {"t5_params": pipe.t5_params, "clip_params": pipe.clip_params,
                           "vae_params": pipe.vae_params}}
    gguf_round_trip(encoders, prompts)
    int8_counts, _ = int8_attention_images(pipe, prompts, args.steps, lat)
    counts.update(int8_counts)
    mark("GGUF round trip, config C")
    pipe.flux_params = None  # free the q8t transformer before the other configs
    earlier = FluxConfig() if args.full_depth else dataclasses.replace(
        FluxConfig(), num_layers=EARLIER_DEPTH[0], num_single_layers=EARLIER_DEPTH[1])
    print(f"the GGUF, B, D0/D/F, dense and E0/E images run {earlier.num_layers} double + "
          f"{earlier.num_single_layers} single blocks at FLUX.1-dev's widths")
    gguf = {kind: gguf_image(kind, encoders, prompts, args.steps, earlier)
            for kind in GGUF_KINDS}
    counts["qmm_affine"] = gguf["q4_0"][0]["qmm_affine"]
    mark("GGUF Q8_0 / Q4_0 images")

    # -- configs A and B: the load-time layout options at full depth ----------
    refs = {"q8t": lat, "q4_0": gguf["q4_0"][1]}
    del gguf
    for config in LAYOUT_CONFIGS:
        layout_counts, t5_fused, _ = layout_image(config, encoders, prompts, args.steps,
                                                  refs[config[1]], earlier)
        for name in config[6] + (("rope_qk",) if "flash_rope" in config[6] else ()):
            if name not in ("qmm_s8", "qmm_affine"):
                counts[name] = layout_counts[name]
        # config B shares config A's fused T5
        encoders = {**encoders, "params": {**encoders["params"], "t5_params": t5_fused}}
    mark("configs A, B")

    # -- configs D0 and D: FLUX.1 in nf4, default and grouped ----------------
    nf4_counts = nf4_images(encoders, prompts, args.steps, earlier)
    for name in ("qmm_grouped_nf4", "qmm_nf4_fast16"):
        counts[name] = nf4_counts[name]
    mark("configs D0, F, D")

    # -- the dense preset, configs E / E0 (ISQ + imatrix + LoRA), the file ----
    del encoders["params"]["t5_params"]  # the nf4 T5s: the configs below bring theirs
    pipe.t5_params = None
    counts["qmm_affine_fast16"] = isq_images(encoders, prompts, args.steps,
                                             earlier)["qmm_affine_fast16"]
    mark("dense preset, configs E, E0")
    isq_file_round_trip(prompts)
    mark("ISQ file round trip")

    # -- config S: phase 4's weights (made again from their seed),
    # sequence-parallel over two ranks. It runs last: what the ranks opened
    # through CUDA IPC stays allocated in this process until it exits.
    gc.collect()
    torch.cuda.empty_cache()
    pipe = make_pipeline(cfgs, make_params(cfgs, seed=0, device="cuda"), device="cuda")
    counts.update(config_s(cfgs, pipe, prompts, args.steps, lat, args.full_depth))
    mark("configs S, T, mesh serve")
    tiled_decode(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase()
    mark("dryrun")

    src = "diffusion_rs_tpu_torch/csrc/"
    qmm_pallas = "diffusion_rs_tpu/ops/qmatmul_pallas.py"
    flash_pallas = "diffusion_rs_tpu/ops/flash_pallas.py"
    # kernel -> (source, pallas_call it replaces, the timed row reported: the
    # heaviest main-path shape; the last for K8-affine is config B's Q4_0)
    sources = {
        "qmm_s8": ("qmm_s8.cu", f"{qmm_pallas}:378", -1),
        "qmm_nf4": ("qmm_nf4.cu", f"{qmm_pallas}:378", -1),
        "qmm_affine": ("qmm_affine.cu", f"{qmm_pallas}:378", -1),
        "flash_fwd": ("flash_fwd.cu", f"{flash_pallas}:396", 0),
        "flash_sm": ("flash_fwd.cu", f"{flash_pallas}:636", 0),
        "flash_rope": ("flash_fwd.cu", f"{flash_pallas}:523", 0),
        "rope_qk": ("flash_fwd.cu", f"{flash_pallas}:523", 0),
        "qk_norm_rope": ("qk_norm_rope.cu", "none: XLA's fusion of models/flux.py's _qkv, the "
                         "joint concatenate and _rope_qk", 0),
        "qmm_grouped_s8": ("qmm_s8.cu", f"{qmm_pallas}:630", -1),
        "qmm_grouped_affine": ("qmm_affine.cu", f"{qmm_pallas}:630", -1),
        "flash_s8": ("flash_fwd.cu", f"{flash_pallas}:396", 0),
        "flash_s8pv": ("flash_fwd.cu", f"{flash_pallas}:396", 0),
        "flash_s8_s8pv": ("flash_fwd.cu", f"{flash_pallas}:396", 0),
        "flash_quant": ("flash_quant.cu", f"{flash_pallas}:223", 0),
        "qmm_grouped_nf4": ("qmm_nf4.cu", f"{qmm_pallas}:630", -1),
        "qmm_nf4_fast16": ("qmm_nf4.cu", f"{qmm_pallas}:378", -1),
        "qmm_affine_fast16": ("qmm_affine.cu", f"{qmm_pallas}:378", -1),
        **{entry: ("flash_fwd.cu", f"{flash_pallas}:396", 0) for entry in LSE_ENTRIES},
        # config T's f32 entries: the heaviest (linear2's K-slice) reported
        "qmm_s8_f32": ("qmm_s8.cu", f"{qmm_pallas}:378", -1),
        "qmm_nf4_f32": ("qmm_nf4.cu", f"{qmm_pallas}:378", -1),
        "qmm_nf4_fast16_f32": ("qmm_nf4.cu", f"{qmm_pallas}:378", -1),
        "qmm_affine_f32": ("qmm_affine.cu", f"{qmm_pallas}:378", -1),
        "qmm_affine_fast16_f32": ("qmm_affine.cu", f"{qmm_pallas}:378", -1),
    }
    kernels = []
    for name, rows in checks.items():
        source, replaces, which = sources[name]
        r = [x for x in rows if "ms" in x][which]
        errs = rows + {"qmm_affine": k4_formats, "qmm_affine_fast16": fast16_formats}.get(
            name, [])
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{source}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{key: r[key] for key in ("library_note", "with_prepass_ms", "design_bound_ms",
                                       "wrapper_ms", "pass1_ms", "bf16_entry_ms",
                                       "pass2_ms", "int8_gemm_ms", "rope_ms") if key in r},
            **({"m1_rows": [{k: x[k] for k in ("shape", "ms", "device_ms", "bound_ms",
                                               "library_ms")} for x in rows
                            if "device_ms" in x]} if name == "qmm_affine" else {}),
            **({"serve_rows": [{k: x[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")}
                               for x in serve_rows if x["shape"].startswith(
                                   "M" if name == "qmm_s8" else "B")]}
               if name in ("qmm_s8", "flash_fwd") else {}),
            **({"other_rows": [{k: x[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")}
                               for x in rows if x is not r and "ms" in x]}
               if name == "qmm_s8_f32" or name == "flash_fwd" else {}),
        })
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise SystemExit(f"kernels launched no time on their paths: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
