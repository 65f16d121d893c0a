"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. Nothing is
built at import time: the first kernel launch builds every source in parallel
(one ``nvcc`` process each) into ``build/torch_kernels/`` beside the package.
A library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused.

No ``--use_fast_math``: the s8 matmul divides and rounds half-to-even exactly
as ``jnp.round(x / sx)`` does, and fast math would change both.

A source may export several entry points (:data:`KERNELS`: the q8t, nf4 and
affine sources also export their grouped forms and their f32-output forms
(``<name>_f32``), the nf4 and affine sources their fast16 forms, the flash source its seq-major, fused-RoPE and int8
forms, the bf16 and int8 forms that also write the log-sum-exp, K14, and
the RoPE pass ``rope_qk`` that K7 launches before its attention; the
quantize source ``flash_quant`` is the int8 forms' prepass).
Every kernel wrapper adds one to its entry point's count in
:data:`LAUNCHES` when it launches it, and nowhere else.

The kernels have no backward: a launch returns a tensor autograd sees as a
constant. So every wrapper hands :func:`launch` its tensor operands, and a
launch under grad mode with an operand that requires grad raises
``RuntimeError`` instead of silently giving the upstream parameters no
gradient (JAX's flash wrapper has no autodiff rule either). A training step
runs attention through ``sdpa_xla`` (DIFFUSION_RS_TPU_NO_FLASH=1) on dense
weights, which launches no kernel.

Threads: the serving path launches kernels from several threads of one
process (a request's text encode on its submitting thread, the batched
steps on the server's worker, the decodes on its decode thread). One
re-entrant lock guards the build, the loaded libraries and entry points,
:data:`BUILD_DIR` and :data:`LAUNCHES`: each process builds each library
once (a second thread that asks during the build waits for it and then
loads the result; a failed build raises on every thread that asked for the
library), and launches are counted exactly from any thread. A thread's
first launch on a card makes the card's primary context current in that
thread (``torch.cuda.set_device``): in a thread that has made no CUDA
runtime call yet, a library's launch fails with cudaErrorInvalidValue.
Processes (spawned ranks) build into pid-named temporaries renamed into
place with ``os.replace``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "DIFFUSION_RS_TORCH_BUILD",
        Path(__file__).resolve().parents[2] / "build" / "torch_kernels",
    )
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
]
SOURCES = ("qmm_s8", "qmm_nf4", "qmm_affine", "flash_fwd", "flash_quant")

# Entry point -> (source, C signature): pointers, host tables and the stream
# as c_void_p, sizes as c_int, strides as c_int64.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
KERNELS = {
    "qmm_s8": ("qmm_s8", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "qmm_grouped_s8": ("qmm_s8", [_P, _I, _I, _I, _I, _P]),
    "qmm_nf4": ("qmm_nf4", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "qmm_grouped_nf4": ("qmm_nf4", [_P, _I, _I, _I, _I, _I, _I, _P]),
    "qmm_nf4_fast16": ("qmm_nf4", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "qmm_affine": ("qmm_affine", [_P] * 5 + [_I] * 7 + [_P]),
    "qmm_grouped_affine": ("qmm_affine", [_P] + [_I] * 8 + [_P]),
    "qmm_affine_fast16": ("qmm_affine", [_P] * 5 + [_I] * 7 + [_P]),
    "flash_fwd": ("flash_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "flash_sm": ("flash_fwd", [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _P]),
    "flash_rope": ("flash_fwd", [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _P]),
    "rope_qk": ("flash_fwd", [_P] * 8 + [_I] * 4 + [_L] * 4 + [_P]),
    "flash_s8": ("flash_fwd", [_P] * 7 + [_I] * 5 + [_F, _P]),
    "flash_s8pv": ("flash_fwd", [_P] * 7 + [_I] * 5 + [_F, _P]),
    "flash_s8_s8pv": ("flash_fwd", [_P] * 7 + [_I] * 5 + [_F, _P]),
    "flash_fwd_lse": ("flash_fwd", [_P] * 5 + [_I] * 4 + [_F, _P]),
    "flash_s8_lse": ("flash_fwd", [_P] * 8 + [_I] * 5 + [_F, _P]),
    "flash_s8pv_lse": ("flash_fwd", [_P] * 8 + [_I] * 5 + [_F, _P]),
    "flash_s8_s8pv_lse": ("flash_fwd", [_P] * 8 + [_I] * 5 + [_F, _P]),
    "flash_quant": ("flash_quant", [_P] * 8 + [_I] * 4 + [_P]),
}
# K1, K2, K12, K4 and K13 storing f32 (a row-parallel linear's partial product)
KERNELS.update({f"{name}_f32": KERNELS[name] for name in (
    "qmm_s8", "qmm_nf4", "qmm_nf4_fast16", "qmm_affine", "qmm_affine_fast16")})

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}
_lock = threading.RLock()


class _ThreadCards(threading.local):
    """Per thread: the cards whose primary context the thread made current."""

    def __init__(self):
        self.cards = set()


_thread = _ThreadCards()


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(LAUNCHES)


def use_build_dir(path: Path) -> Path:
    """Build and load the libraries under ``path`` from now on
    (util/compile_cache.py). Returns the directory in effect: the present
    one, unchanged, once a library has been loaded from it."""
    global BUILD_DIR
    with _lock:
        if not _LIBS:
            BUILD_DIR = Path(path)
        return BUILD_DIR


def _nvcc() -> str:
    cands = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build at first launch on a machine with the toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per source
    (0.0 for a library that was already built). Raises on any failure, with
    the compiler's output."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            log = open(out.with_suffix(".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                           tmp, out, log)
        times = {name: 0.0 for name in SOURCES}
        failed = []
        for name, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            times[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(f"{name} (rc {rc}):\n{out.with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def _entry(name: str):
    with _lock:
        fn = _FNS.get(name)
        if fn is None:
            source, sig = KERNELS[name]
            fn = getattr(library(source), name)
            fn.argtypes = sig
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return fn


def int8_layout(s8: bool, s8_pv: bool) -> Tuple[int, int, int]:
    """The int8 flash body's (kv rows per tile, ring stages, shared-memory
    bytes) for a mode, as ``csrc/flash_fwd.cu`` compiled them (its
    ``flash_int8_layout``, which launches nothing and counts no launch)."""
    fn = library("flash_fwd").flash_int8_layout
    kv, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = fn(ctypes.c_int(int(s8)), ctypes.c_int(int(s8_pv)), ctypes.byref(kv),
             ctypes.byref(stages), ctypes.byref(smem))
    if err != 0:
        raise ValueError(f"flash_int8_layout: no int8 mode (error {err})")
    return kv.value, stages.value, smem.value


def check_no_grad(name: str, inputs) -> None:
    """Raise when grad mode is on and a tensor of ``inputs`` requires grad:
    the kernel behind wrapper ``name`` has no backward."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: a hand-written CUDA kernel has no backward, and an input requires "
            "grad under grad mode (its output would be a constant to autograd). Run it "
            "under torch.no_grad(), or train with DIFFUSION_RS_TPU_NO_FLASH=1 (attention "
            "through sdpa_xla) and dense weights (plain matmuls)")


def launch(name: str, *args, device, inputs=()) -> None:
    """Call entry point ``<name>(...)`` on ``device`` (the card its operands
    lie on), on that card's current stream; raise on a CUDA error. The
    launch runs under that device's context whatever the thread's current
    device is, so a rank whose tensors lie on ``cuda:r`` launches there.
    ``inputs``: the wrapper's tensor operands, for :func:`check_no_grad`."""
    import torch

    check_no_grad(name, inputs)
    with torch.cuda.device(device):
        card = torch.cuda.current_device()
        if card not in _thread.cards:
            torch.cuda.set_device(card)  # forces cudaSetDevice: the context, current here
            _thread.cards.add(card)
        call(name, args, torch.cuda.current_stream(device).cuda_stream)


def call(name: str, args, stream) -> None:
    """Call entry point ``<name>(*args, stream)``, raise on its error code,
    and count the launch."""
    err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    with _lock:
        LAUNCHES[name] += 1
