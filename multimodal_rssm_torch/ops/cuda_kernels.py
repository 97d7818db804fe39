"""Hand-written CUDA kernels of the port: build, bind, plain versions.

Every ``kernels/*.cu`` source is its own library with a plain C interface,
loaded with ``ctypes``:

- ``normalize_image.cu``: the bit-depth normalise (K1, replacing the JAX
  package's Pallas ``normalize_image_pallas``), bound and wrapped here;
- ``fused_codec.cu``: the fused conv + InstanceNorm + GLU forward and its
  three backward steps (K2, K3a-c), bound and wrapped in
  ``ops/fused_codec.py``.

Each source note gives the kernel's bound and design.

- ``build`` compiles the libraries with ``nvcc`` for ``sm_90a`` at first use
  into ``build/torch_kernels/`` beside the package, one ``nvcc`` per source,
  all started together; a library is rebuilt when its source, or any
  ``kernels/*.cuh``, is newer.
- A wrapper takes its plain PyTorch version only for a tensor on the CPU.
  A CUDA tensor goes through the kernel or raises: there is no fallback.
- Each wrapper's ``launches`` counts kernel launches (and nothing else), so
  a run can show that the main path went through the kernel; ``KERNELS``
  names them all for ``reset_launch_counts`` and ``launch_counts``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import glob
import time
from typing import Callable, Dict, Tuple

import torch

from multimodal_rssm_torch.ops.image import normalize_image_deterministic

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_DIR = os.path.join(_PKG_DIR, "kernels")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# -- build and bind ---------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return path


def sources() -> Dict[str, str]:
    """{library name: source path} for every ``kernels/*.cu``."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(KERNEL_DIR, "*.cu")))}


def build(force: bool = False) -> Tuple[Dict[str, str], float, str]:
    """Compile every kernel library that is missing or older than its source
    (or than any ``kernels/*.cuh``): one ``nvcc`` per source, all started
    together.

    Returns ({name: library path}, wall seconds of the build (0 when every
    library is up to date), the compilers' output, ptxas's included).
    """
    headers = glob.glob(os.path.join(KERNEL_DIR, "*.cuh"))
    srcs = sources()
    libs = {name: os.path.join(BUILD_DIR, f"libmrssm_{name}.so")
            for name in srcs}
    stale = {}
    for name, src in srcs.items():
        newest = max(os.path.getmtime(p) for p in [src, *headers])
        if (force or not os.path.exists(libs[name])
                or os.path.getmtime(libs[name]) < newest):
            stale[name] = src
    if not stale:
        return libs, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, src in stale.items():
        tmp = f"{libs[name]}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
        else:
            os.replace(tmp, libs[name])
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    return libs, seconds, log


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built first where it is stale)."""
    libs, _, _ = build()
    return ctypes.CDLL(libs[name])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("normalize_image")
    lib.mrssm_normalize_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.mrssm_normalize_image.restype = ctypes.c_int
    lib.mrssm_error_string.argtypes = [ctypes.c_int]
    lib.mrssm_error_string.restype = ctypes.c_char_p
    return lib


# -- Philox4x32-10 on int64 tensors ----------------------------------------


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    ``b`` (int64 holding values < 2^32), through 16-bit limbs so that no
    partial product leaves int64's range."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p0 = b_lo * a_lo
    p1 = b_lo * a_hi
    p2 = b_hi * a_lo
    p3 = b_hi * a_hi
    mid = (p0 >> 16) + (p1 & 0xFFFF) + (p2 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)
    hi = p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of counters (g lo, g hi, 0, 0) under key (seed lo,
    seed hi): int64 ``counter`` [n] -> int64 words [n, 4], each < 2^32.
    The same rounds as ``philox4x32_10`` in kernels/normalize_image.cu."""
    c0 = counter & _MASK32
    c1 = (counter >> 32) & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = seed & _MASK32
    k1 = (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def normalize_noise_plain(n: int, bit_depth: int, seed: torch.Tensor
                          ) -> torch.Tensor:
    """The dequantisation noise u / 2^bit_depth of elements 0..n-1 (flat
    float32 on ``seed``'s device), u = float((bits >> 9) | 0x3F800000) - 1."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=seed.device)
    bits = philox4x32_10(groups, seed.reshape(())).reshape(-1)[:n]
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u / 2 ** bit_depth


def normalize_image_plain(x: torch.Tensor, bit_depth: int,
                          seed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same bits, the same result."""
    noise = normalize_noise_plain(x.numel(), bit_depth, seed)
    return normalize_image_deterministic(x, bit_depth) + noise.reshape(x.shape)


# -- the wrapper --------------------------------------------------------------


def normalize_image(x: torch.Tensor, bit_depth: int,
                    seed: torch.Tensor) -> torch.Tensor:
    """Fused bit-depth normalise: quantise ``x`` (values in [0, 255], f32 or
    uint8) to ``bit_depth`` bits, map to [-0.5, 0.5) and add uniform
    dequantisation noise keyed by ``seed`` (an int64 scalar tensor in
    [0, 2^63) on ``x``'s device).  Returns float32 of ``x``'s shape.

    CPU tensors take ``normalize_image_plain``; CUDA tensors launch the
    kernel (or raise)."""
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"normalize_image takes float32 or uint8, got {x.dtype}")
    if not 1 <= int(bit_depth) <= 8:
        raise ValueError(f"bit_depth {bit_depth} not in [1, 8]")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError("seed must be one int64 element")
    if seed.device != x.device:
        raise ValueError(f"seed on {seed.device}, x on {x.device}")
    if x.device.type == "cpu":
        return normalize_image_plain(x, bit_depth, seed)
    if x.device.type != "cuda":
        raise ValueError(f"normalize_image has no kernel for {x.device}")
    x = x.contiguous()
    seed = seed.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mrssm_normalize_image(
            x.data_ptr(), int(x.dtype == torch.uint8), out.data_ptr(),
            x.numel(), int(bit_depth), seed.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("normalize_image kernel launch failed: "
                           + lib.mrssm_error_string(rc).decode())
    normalize_image.launches += 1
    return out


normalize_image.launches = 0

# Every kernel wrapper by name; ops/fused_codec.py adds K2-K3c when it is
# imported, which ``_all_kernels`` makes sure of.
KERNELS: Dict[str, Callable] = {"normalize_image": normalize_image}


def _all_kernels() -> Dict[str, Callable]:
    from multimodal_rssm_torch.ops import fused_codec  # noqa: F401

    return KERNELS


def reset_launch_counts() -> None:
    for fn in _all_kernels().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _all_kernels().items()}
