"""ctypes binding of the host-side chunk gather (``csrc/gather.cpp``).

``g++`` builds the library at first use into ``build/torch_native/`` beside
the package, and again when the source is newer.  A failed build raises:
the replay never switches to another gather behind the caller's back.
``gather_chunks_plain`` is the NumPy version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "gather.cpp")
LIBRARY = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native",
                       "libmrssm_gather.so")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def build() -> str:
    """Compile the library when it is missing or older than its source;
    returns its path.  Raises ``RuntimeError`` with the compiler's output
    when ``g++`` fails or is missing."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"   # concurrent builders: atomic swap
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.mrssm_gather_chunks.restype = ctypes.c_int
    lib.mrssm_gather_chunks.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]
    return lib


def _check_indices(idxs: np.ndarray) -> None:
    if idxs.ndim != 2 or not np.issubdtype(idxs.dtype, np.integer):
        raise TypeError(f"idxs must be an integer [n, L] matrix, got "
                        f"{idxs.dtype} {idxs.shape}")


def gather_chunks_plain(src: np.ndarray, idxs: np.ndarray) -> np.ndarray:
    """NumPy version: src [N, ...], idxs [n, L] -> [L, n, ...].  Raises
    ``IndexError`` as the native gather does (NumPy alone would wrap
    negative indices)."""
    _check_indices(idxs)
    if idxs.size and (idxs.min() < 0 or idxs.max() >= src.shape[0]):
        raise IndexError(f"gather index out of range [0, {src.shape[0]})")
    n, L = idxs.shape
    return src[idxs.T.reshape(-1)].reshape(L, n, *src.shape[1:])


def gather_chunks(src: np.ndarray, idxs: np.ndarray, num_threads: int = 0,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather buffer rows time-major with the native library: src [N, ...]
    (C-contiguous), idxs [n, L] -> [L, n, ...], written into ``out`` when
    given (C-contiguous, of that shape and src's dtype: the host feed passes
    a pinned staging array, so the batch is gathered once, straight into
    memory the device copy reads, with no fresh pages to fault in).
    ``num_threads`` <= 0 uses one thread per MiB of output, up to 4 host
    cores.  Out-of-range indices raise ``IndexError``."""
    if not src.flags["C_CONTIGUOUS"]:
        raise ValueError("gather_chunks takes a C-contiguous source")
    _check_indices(idxs)
    n, L = idxs.shape
    shape = (L, n, *src.shape[1:])
    if out is None:
        out = np.empty(shape, src.dtype)
    elif (out.shape != shape or out.dtype != src.dtype
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be a C-contiguous {src.dtype} array of "
                         f"shape {shape}, got {out.dtype} {out.shape}")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if num_threads <= 0:
        # a thread per MiB gathered, up to 4 cores: a thread costs tens of
        # microseconds to start, a small array's whole gather less, and the
        # loop's thread needs a core to queue the step meanwhile
        num_threads = max(1, min(os.cpu_count() or 1, 4,
                                 n * L * row_bytes >> 20))
    idx64 = np.ascontiguousarray(idxs, np.int64)
    rc = _library().mrssm_gather_chunks(
        src.ctypes.data, src.shape[0], row_bytes, idx64.ctypes.data, n, L,
        out.ctypes.data, num_threads)
    if rc != 0:
        raise IndexError(f"gather index out of range [0, {src.shape[0]})")
    return out
