"""ctypes bindings for the native host IO / repack engine (the port's own copy
of ``diffusion_rs_tpu/io/native.py``, over the same ``native/drs_io.cpp``).

On first use the library is built with ``g++`` (no dependencies) into the
repository's ``build/drs_io/``, under a name that carries the source's hash,
so an edited source is rebuilt. Every entry point has a numpy fallback, as
in the JAX package: without a toolchain, or with DIFFUSION_RS_TPU_NO_NATIVE
set, the host work runs in numpy. The native paths parallelize the host
work of checkpoint loading: the transpose to K-major, the bnb nibble
repack, and positioned span reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("diffusion_rs_tpu_torch")

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "drs_io.cpp"
_BUILD = _ROOT / "build" / "drs_io"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes()).hexdigest()[:12]
    return _BUILD / f"libdrs_io-{digest}.so"


def _build(out: Path) -> bool:
    """g++ into a temporary name, then an atomic rename (parallel test
    workers may build at once)."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-pthread", "-shared",
                        "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of the library's C entry points."""
    u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    for name, args in (
            ("drs_transpose_2d", [ctypes.c_void_p, ctypes.c_void_p, i64, i64, ctypes.c_int]),
            ("drs_bnb_repack4", [u8p, u8p, i64, i64, i64]),
            ("drs_file_read_spans", [ctypes.c_char_p, i64, i64p, i64p,
                                     ctypes.POINTER(u8p), ctypes.c_int]),
            ("drs_version", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (DIFFUSION_RS_TPU_NO_NATIVE set, no
    source, or no toolchain); decided once per process."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DIFFUSION_RS_TPU_NO_NATIVE") or not _SOURCE.exists():
            return None
        path = _lib_path()
        if not (path.exists() or _build(path)):
            return None
        try:
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            if lib.drs_version() == 1:
                _lib = lib
        except OSError as e:
            log.debug("native load failed: %s", e)
        return _lib


def transpose_2d(src: np.ndarray) -> np.ndarray:
    """Parallel [rows, cols] -> [cols, rows] (torch layout -> K-major)."""
    lib = get_lib()
    if lib is None or src.dtype.itemsize not in (1, 2, 4, 8):
        return np.ascontiguousarray(src.T)
    src = np.ascontiguousarray(src)
    rows, cols = src.shape
    dst = np.empty((cols, rows), src.dtype)
    rc = lib.drs_transpose_2d(src.ctypes.data_as(ctypes.c_void_p),
                              dst.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(rows),
                              ctypes.c_int64(cols), ctypes.c_int(src.dtype.itemsize))
    return dst if rc == 0 else np.ascontiguousarray(src.T)


def bnb_repack4(weight_bytes: np.ndarray, n_out: int, n_in: int,
                split: int) -> Optional[np.ndarray]:
    """bnb flat nibble stream -> canonical split-block packed [K/2, N].
    None when the native path is unavailable (the caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(weight_bytes.reshape(-1).view(np.uint8))
    if src.size != n_out * n_in // 2:
        return None
    dst = np.empty((n_in // 2, n_out), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.drs_bnb_repack4(src.ctypes.data_as(u8), dst.ctypes.data_as(u8),
                             ctypes.c_int64(n_out), ctypes.c_int64(n_in), ctypes.c_int64(split))
    return dst if rc == 0 else None


def read_spans(path: str, offsets, sizes, threads: int = 0) -> Optional[list]:
    """Parallel positioned reads of ``path``: one owned u8 array per span,
    or None when the native path is unavailable or a read fails."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(offsets)
    bufs = [np.empty(int(s), np.uint8) for s in sizes]
    u8 = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8 * n)(*[b.ctypes.data_as(u8) for b in bufs])
    off = np.asarray(offsets, np.int64)
    siz = np.asarray(sizes, np.int64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.drs_file_read_spans(str(path).encode(), ctypes.c_int64(n),
                                 off.ctypes.data_as(i64), siz.ctypes.data_as(i64), ptrs,
                                 ctypes.c_int(threads))
    return bufs if rc == 0 else None
