"""Fused stride-1 conv + train-mode InstanceNorm + GLU, forward and backward.

The port of the JAX package's ``ops/fused_codec.py``: the op of the sound
codec's stride-1 stages (SoundEncoderV2 ``down4``, SoundDecoderV2 ``up0``).
As there, no module calls it: it is a standalone, verified op driven by
``cli/verify_fused_codec.py`` and the tests.  Its four kernels are
hand-written CUDA in ``kernels/fused_codec.cu`` (the source note gives each
one's bound and design):

- K2  ``conv_in_glu_fwd``: conv -> per-instance stats -> affine -> GLU;
- K3a ``in_glu_bwd_dz``: GLU + affine + InstanceNorm backward, dy -> dz,
  with the (dscale, dbias) sums, in one pass over dy and z (both dtypes);
- K3b ``conv_dgrad``: dx, the conv of padded dz with the flipped,
  transposed kernel;
- K3c ``conv_wgrad``: dw, summed over every sample in f32.

K2, K3b and K3c each have two kernels.  bf16 with the channel counts
multiples of 64 (the codec's 256 / 512: Cin and Cout / 2 for K2, Cin and
Cout for K3b and K3c) takes the Hopper kernel (``wgmma``, its operands
brought by TMA for K2 and by a ``cp.async`` ring for K3b and K3c;
counted by ``conv_in_glu_fwd_wgmma``, ``conv_dgrad_wgmma`` and
``conv_wgrad_wgmma``); every other dtype and shape takes the WMMA kernel
(counted by ``conv_in_glu_fwd``, ``conv_dgrad`` and ``conv_wgrad``).
``fwd_uses_wgmma`` (K2) and ``uses_wgmma`` (K3b, K3c) make the choice,
from dtype and shape only, before any launch.

Each wrapper takes its plain PyTorch version (``*_plain``: the kernel's own
arithmetic, pad + tap gather + matmul in f32) only for CPU tensors; a CUDA
tensor launches a kernel or raises, and counts the launch.  Layouts are
the JAX op's: x [N, H, W, Cin], w [kh, kw, Cin, Cout] (Cout even), scale and
bias [Cout].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_rssm_torch.ops import cuda_kernels as ck

DTYPES = (torch.float32, torch.bfloat16)
MAX_POSITIONS = 256     # K2, K3a: a block holds a sample's Ho * Wo positions
_BK = 32                # K3c (WMMA): depth rows per shared-memory stage
_TILE = 128             # K3c (WMMA): rows and columns of a block's dw tile
WG_STAGE = 64           # wgmma kernels: depth per stage, channel multiple
WG_TILE = (128, 256)    # wgmma kernels: rows x columns of a block's tile
MAX_SPLITS = 32         # K3c: most depth splits (f32 partials)


# -- shapes and checks --------------------------------------------------------


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def _out_size(h: int, k: int, p: int) -> int:
    return h + 2 * p - k + 1


def _check(name: str, *tensors: torch.Tensor, dtype=None) -> None:
    """Same device, contiguous, and (where given) the one dtype."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: takes contiguous tensors only")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for {dev}")


def _check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {t.dtype}")


def _check_conv(name: str, x: torch.Tensor, w: torch.Tensor,
                padding: Tuple[int, int]) -> Tuple[int, int]:
    """x [N, H, W, Cin] and w [kh, kw, Cin, Cout] of one dtype; returns
    (Ho, Wo)."""
    _check_dtype(name, x)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not [N, H, W, Cin] and [kh, kw, Cin, Cout]")
    _check(name, x, w, dtype=x.dtype)
    ph, pw = padding
    ho = _out_size(x.shape[1], w.shape[0], ph)
    wo = _out_size(x.shape[2], w.shape[1], pw)
    if min(ph, pw) < 0 or ho < 1 or wo < 1:
        raise ValueError(f"{name}: padding {padding} gives no output")
    return ho, wo


# -- the library ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ck.load_library("fused_codec")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mrssm_conv_in_glu_fwd.argtypes = [i] + [p] * 8 + [i] * 9 + [f, p]
    lib.mrssm_conv_in_glu_fwd_wgmma.argtypes = [p] * 8 + [i] * 9 + [f, p]
    lib.mrssm_in_glu_bwd_dz.argtypes = [i] + [p] * 9 + [i] * 3 + [f, p]
    lib.mrssm_conv_dgrad.argtypes = [i] + [p] * 3 + [i] * 9 + [p]
    lib.mrssm_conv_wgrad.argtypes = ([i] + [p] * 4 + [i] * 10
                                     + [ctypes.c_longlong, p])
    lib.mrssm_conv_dgrad_wgmma.argtypes = [p] * 3 + [i] * 9 + [p]
    lib.mrssm_conv_wgrad_wgmma.argtypes = ([p] * 4 + [i] * 10
                                           + [ctypes.c_longlong, p])
    for fn in (lib.mrssm_conv_in_glu_fwd, lib.mrssm_conv_in_glu_fwd_wgmma,
               lib.mrssm_in_glu_bwd_dz,
               lib.mrssm_conv_dgrad, lib.mrssm_conv_wgrad,
               lib.mrssm_conv_dgrad_wgmma, lib.mrssm_conv_wgrad_wgmma):
        fn.restype = ctypes.c_int
    lib.mrssm_fused_codec_error_string.argtypes = [i]
    lib.mrssm_fused_codec_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` on ``device``'s current stream; raise
    on a non-zero cudaError."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _lib().mrssm_fused_codec_error_string(rc).decode())


def _dtype_code(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def uses_wgmma(dtype: torch.dtype, cin: int, cout: int, kh: int) -> bool:
    """Whether K3b and K3c take their Hopper (wgmma) kernel for this dtype,
    these conv channel counts and kernel height: bf16 with Cin and Cout
    multiples of 64 and at most 32 taps high (K3b keeps a block's valid
    taps dh in one 32-bit mask).  Decided before any launch; the other
    cases take the WMMA kernels.  The C entry points only guard the rule
    (an error code, never another kernel)."""
    return (dtype == torch.bfloat16 and cin % WG_STAGE == 0
            and cout % WG_STAGE == 0 and kh <= 32)


def fwd_uses_wgmma(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether K2 takes its Hopper (wgmma) kernel for this dtype and these
    conv channel counts: bf16 with Cin and Cout / 2 multiples of 64 (any
    kernel size; at most ``MAX_POSITIONS`` positions, which every K2
    kernel needs).  Decided before any launch; the other cases take the
    WMMA kernel.  The C entry point only guards the rule."""
    return (dtype == torch.bfloat16 and cin % WG_STAGE == 0
            and (cout // 2) % WG_STAGE == 0)


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The wgmma kernels copy 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the wgmma kernel takes 16-byte-aligned "
                         "tensors (a contiguous view at an odd offset is not)")


# -- plain versions (the kernels' arithmetic, f32) ------------------------------


def _taps(x: torch.Tensor, kh: int, kw: int,
          padding: Tuple[int, int]) -> torch.Tensor:
    """f32 [N, Ho, Wo, kh*kw*C] of the zero-padded x, taps in (dh, dw, c)
    order: the rows of the implicit GEMM, written out."""
    ph, pw = padding
    xp = F.pad(x.float(), (0, 0, pw, pw, ph, ph))
    ho = xp.shape[1] - kh + 1
    wo = xp.shape[2] - kw + 1
    return torch.cat([xp[:, dh:dh + ho, dw:dw + wo, :]
                      for dh in range(kh) for dw in range(kw)], dim=-1)


def _conv_plain(x: torch.Tensor, w: torch.Tensor,
                padding: Tuple[int, int]) -> torch.Tensor:
    """f32 stride-1 conv: [N, H, W, Cin] x [kh, kw, Cin, Cout]."""
    kh, kw, _, cout = w.shape
    cols = _taps(x, kh, kw, padding)
    return (cols.reshape(-1, cols.shape[-1]) @ w.float().reshape(-1, cout)
            ).reshape(*cols.shape[:3], cout)


def conv_in_glu_fwd_plain(x, w, scale, bias, padding, eps: float = 1e-5):
    """K2's plain version: (y, z) in x's dtype, (mean, var) f32 [N, Cout]."""
    z = _conv_plain(x, w, padding)
    mean = z.mean(dim=(1, 2))
    var = torch.clamp((z * z).mean(dim=(1, 2)) - mean * mean, min=0.0)
    a = scale.float() * torch.rsqrt(var + eps)
    b = bias.float() - mean * a
    zn = z * a[:, None, None, :] + b[:, None, None, :]
    c2 = z.shape[-1] // 2
    y = zn[..., :c2] * torch.sigmoid(zn[..., c2:])
    return y.to(x.dtype), z.to(x.dtype), mean, var


def in_glu_bwd_dz_plain(dy, z, mean, var, scale, bias, eps: float = 1e-5):
    """K3a's plain version (the JAX kernel's formula): dz in z's dtype and
    the f32 sums (dscale, dbias) over every sample and position."""
    zf = z.float()
    rstd = torch.rsqrt(var + eps)[:, None, None, :]
    scale = scale.float()
    zhat = (zf - mean[:, None, None, :]) * rstd
    zn = zhat * scale + bias.float()
    c2 = z.shape[-1] // 2
    sig = torch.sigmoid(zn[..., c2:])
    d = dy.float()
    dzn = torch.cat([d * sig, d * zn[..., :c2] * sig * (1.0 - sig)], dim=-1)
    dscale = (dzn * zhat).sum(dim=(0, 1, 2))
    dbias = dzn.sum(dim=(0, 1, 2))
    dzhat = dzn * scale
    m1 = dzhat.mean(dim=(1, 2), keepdim=True)
    m2 = (dzhat * zhat).mean(dim=(1, 2), keepdim=True)
    dz = rstd * (dzhat - m1 - zhat * m2)
    return dz.to(z.dtype), dscale, dbias


def _dgrad_weight(w: torch.Tensor) -> torch.Tensor:
    """w2 = flip(w, (0, 1)) transposed to [kh, kw, Cout, Cin]."""
    return torch.flip(w, (0, 1)).permute(0, 1, 3, 2).contiguous()


def _dgrad_padding(w: torch.Tensor, padding) -> Tuple[int, int]:
    return w.shape[0] - 1 - padding[0], w.shape[1] - 1 - padding[1]


def conv_dgrad_plain(dz, w, padding):
    """K3b's plain version: dx [N, H, W, Cin] in dz's dtype from dz
    [N, Ho, Wo, Cout] and the forward's w and padding."""
    return _conv_plain(dz, _dgrad_weight(w),
                       _dgrad_padding(w, padding)).to(dz.dtype)


def conv_wgrad_plain(x, dz, kernel_size, padding):
    """K3c's plain version: dw f32 [kh, kw, Cin, Cout] =
    taps(x)^T . dz over every (n, h', w')."""
    kh, kw = kernel_size
    cols = _taps(x, kh, kw, padding)
    dw = cols.reshape(-1, cols.shape[-1]).T @ dz.float().reshape(
        -1, dz.shape[-1])
    return dw.reshape(kh, kw, x.shape[-1], dz.shape[-1])


# -- the kernels' wrappers ------------------------------------------------------


def conv_in_glu_fwd(x, w, scale, bias, padding, eps: float = 1e-5,
                    stride=1):
    """K2: (y [N, Ho, Wo, Cout/2], z [N, Ho, Wo, Cout]) in x's dtype and
    (mean, var) f32 [N, Cout].  x and w of one dtype (f32 or bf16), scale
    and bias f32 [Cout], Ho * Wo <= 256.  On the card, the kernel that
    ``fwd_uses_wgmma`` picks."""
    if _pair(stride) != (1, 1):
        raise ValueError(f"conv_in_glu_fwd takes stride 1 only, got {stride}")
    padding = _pair(padding)
    ho, wo = _check_conv("conv_in_glu_fwd", x, w, padding)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    if cout % 2:
        raise ValueError(f"conv_in_glu_fwd: Cout {cout} is odd (GLU halves)")
    if ho * wo > MAX_POSITIONS:
        raise ValueError(f"conv_in_glu_fwd: {ho} x {wo} output positions, "
                         f"the kernel holds at most {MAX_POSITIONS}")
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError("conv_in_glu_fwd: scale and bias must be [Cout]")
    _check("conv_in_glu_fwd", x, scale, bias)
    _check("conv_in_glu_fwd", scale, bias, dtype=torch.float32)
    if x.device.type == "cpu":
        return conv_in_glu_fwd_plain(x, w, scale, bias, padding, eps)
    y = torch.empty((n, ho, wo, cout // 2), dtype=x.dtype, device=x.device)
    z = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    mean = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    if fwd_uses_wgmma(x.dtype, cin, cout):
        conv_in_glu_fwd_wgmma(x, w, scale, bias, (y, z, mean, var), padding,
                              eps)
        return y, z, mean, var
    lib = _lib()
    _launch("conv_in_glu_fwd", lib.mrssm_conv_in_glu_fwd, x.device,
            _dtype_code(x), x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), z.data_ptr(), mean.data_ptr(),
            var.data_ptr(), n, h, wd, cin, kh, kw, cout, *padding, eps)
    conv_in_glu_fwd.launches += 1
    return y, z, mean, var


def conv_in_glu_fwd_wgmma(x, w, scale, bias, out, padding, eps) -> None:
    """K2's Hopper kernel: out = (y, z, mean, var) from bf16 x [N, H, W,
    Cin] and w [kh, kw, Cin, Cout], Cin and Cout / 2 multiples of 64
    (``conv_in_glu_fwd`` checks and allocates)."""
    y, z, mean, var = out
    _check_aligned("conv_in_glu_fwd", x, w, y, z)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    _launch("conv_in_glu_fwd", _lib().mrssm_conv_in_glu_fwd_wgmma, x.device,
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), z.data_ptr(), mean.data_ptr(), var.data_ptr(), n, h,
            wd, cin, kh, kw, cout, *padding, eps)
    conv_in_glu_fwd_wgmma.launches += 1


def in_glu_bwd_dz(dy, z, mean, var, scale, bias, eps: float = 1e-5):
    """K3a: dz [N, Ho, Wo, Cout] in z's dtype, and f32 dscale, dbias
    [Cout] (the per-sample partials the kernel writes, summed here).
    Ho * Wo <= 256, as K2 makes it."""
    _check_dtype("in_glu_bwd_dz", z)
    n, ho, wo, cout = z.shape
    if cout % 2 or dy.shape != (n, ho, wo, cout // 2):
        raise ValueError(f"in_glu_bwd_dz: dy {tuple(dy.shape)} does not "
                         f"match z {tuple(z.shape)} with an even Cout")
    if (mean.shape != (n, cout) or var.shape != (n, cout)
            or scale.shape != (cout,) or bias.shape != (cout,)):
        raise ValueError("in_glu_bwd_dz: mean, var [N, Cout] and scale, "
                         "bias [Cout] expected")
    if ho * wo > MAX_POSITIONS:
        raise ValueError(f"in_glu_bwd_dz: {ho} x {wo} positions, the kernel "
                         f"holds at most {MAX_POSITIONS}")
    _check("in_glu_bwd_dz", dy, z, dtype=z.dtype)
    _check("in_glu_bwd_dz", z, mean, var, scale, bias)
    _check("in_glu_bwd_dz", mean, var, scale, bias, dtype=torch.float32)
    if z.device.type == "cpu":
        return in_glu_bwd_dz_plain(dy, z, mean, var, scale, bias, eps)
    dz = torch.empty_like(z)
    parts = torch.empty((2, n, cout), dtype=torch.float32, device=z.device)
    lib = _lib()
    _launch("in_glu_bwd_dz", lib.mrssm_in_glu_bwd_dz, z.device,
            _dtype_code(z), dy.data_ptr(), z.data_ptr(), mean.data_ptr(),
            var.data_ptr(), scale.data_ptr(), bias.data_ptr(), dz.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), n, ho * wo, cout, eps)
    in_glu_bwd_dz.launches += 1
    dscale, dbias = parts.sum(dim=1)
    return dz, dscale, dbias


def conv_dgrad(dz, w, padding):
    """K3b: dx [N, H, W, Cin] in dz's dtype, from dz [N, Ho, Wo, Cout] and
    the forward's w [kh, kw, Cin, Cout] (cast to dz's dtype) and padding:
    the stride-1 conv of dz, padded by (kh-1-ph, kw-1-pw), with
    w2 = flip(w) transposed to [kh, kw, Cout, Cin]."""
    padding = _pair(padding)
    _check_dtype("conv_dgrad", dz)
    w2 = _dgrad_weight(w.to(dz.dtype))
    pad2 = _dgrad_padding(w, padding)
    _check_conv("conv_dgrad", dz, w2, pad2)
    if dz.device.type == "cpu":
        return conv_dgrad_plain(dz, w.to(dz.dtype), padding)
    n, ho, wo, cout = dz.shape
    kh, kw, _, cin = w2.shape
    h, wd = _out_size(ho, kh, pad2[0]), _out_size(wo, kw, pad2[1])
    dx = torch.empty((n, h, wd, cin), dtype=dz.dtype, device=dz.device)
    if uses_wgmma(dz.dtype, cin, cout, kh):
        conv_dgrad_wgmma(dz, w2, dx, pad2)
        return dx
    lib = _lib()
    _launch("conv_dgrad", lib.mrssm_conv_dgrad, dz.device, _dtype_code(dz),
            dz.data_ptr(), w2.data_ptr(), dx.data_ptr(), n, ho, wo, cout, kh,
            kw, cin, *pad2)
    conv_dgrad.launches += 1
    return dx


def conv_dgrad_wgmma(dz, w2, dx, pad2) -> None:
    """K3b's Hopper kernel: dx [N, H, W, Cin] <- the stride-1 conv of dz
    [N, Ho, Wo, Cout] padded by ``pad2`` with w2 [kh, kw, Cout, Cin], all
    bf16, Cin and Cout multiples of 64 (``conv_dgrad`` checks and forms
    w2)."""
    _check_aligned("conv_dgrad", dz, w2, dx)
    n, ho, wo, cout = dz.shape
    kh, kw, _, cin = w2.shape
    _launch("conv_dgrad", _lib().mrssm_conv_dgrad_wgmma, dz.device,
            dz.data_ptr(), w2.data_ptr(), dx.data_ptr(), n, ho, wo, cout, kh,
            kw, cin, *pad2)
    conv_dgrad_wgmma.launches += 1


def wgrad_splits(rows: int, tiles: int, stage: int,
                 blocks: int) -> Tuple[int, int]:
    """(splits, rows per split) of K3c, whose ``tiles`` output tiles each
    run once per split, ``blocks`` blocks at a time on the card.  Each split
    is a whole number of ``stage``-row stages and there are at most
    ``MAX_SPLITS``; where the rows allow, enough splits for two waves.
    Among those, the plan whose waves x stages per block (the time, in
    stages) is least; the fewest splits on a tie."""
    stages = -(-rows // stage)
    want = min(MAX_SPLITS, stages, -(-2 * blocks // tiles))
    best = None
    for per in range(-(-stages // MAX_SPLITS), -(-stages // want) + 1):
        splits = -(-stages // per)
        key = (splits < want, -(-splits * tiles // blocks) * per, splits)
        if best is None or key < best[0]:
            best = (key, splits, per)
    return best[1], best[2] * stage


def conv_wgrad(x, dz, kernel_size, padding):
    """K3c: dw f32 [kh, kw, Cin, Cout] = sum over (n, h', w') of the padded
    x's taps times dz, for x [N, H, W, Cin] and dz [N, Ho, Wo, Cout] of one
    dtype."""
    kh, kw = _pair(kernel_size)
    padding = _pair(padding)
    _check_dtype("conv_wgrad", x)
    n, h, wd, cin = x.shape
    ho, wo = _out_size(h, kh, padding[0]), _out_size(wd, kw, padding[1])
    if dz.dim() != 4 or dz.shape[:3] != (n, ho, wo):
        raise ValueError(f"conv_wgrad: dz {tuple(dz.shape)} is not the "
                         f"output of x {tuple(x.shape)} under k ({kh}, {kw}), "
                         f"padding {padding}")
    _check("conv_wgrad", x, dz, dtype=x.dtype)
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dz, (kh, kw), padding)
    cout = dz.shape[-1]
    k = kh * kw * cin
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    wgmma = uses_wgmma(x.dtype, cin, cout, kh)
    # wgmma: 64-row stages, 128 x 256 tiles, one block per SM; WMMA: 32-row
    # stages, 128 x 128 tiles, two blocks per SM
    (bm, bn), stage, per_sm = ((WG_TILE, WG_STAGE, 1) if wgmma
                               else ((_TILE, _TILE), _BK, 2))
    splits, per = wgrad_splits(n * ho * wo, -(-k // bm) * -(-cout // bn),
                               stage, per_sm * sms)
    part = torch.empty((splits, k, cout), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((kh, kw, cin, cout), dtype=torch.float32,
                     device=x.device)
    if wgmma:
        conv_wgrad_wgmma(x, dz, part, dw, padding, per)
        return dw
    lib = _lib()
    _launch("conv_wgrad", lib.mrssm_conv_wgrad, x.device, _dtype_code(x),
            x.data_ptr(), dz.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h,
            wd, cin, kh, kw, cout, *padding, splits, per)
    conv_wgrad.launches += 1
    return dw


def conv_wgrad_wgmma(x, dz, part, dw, padding, per) -> None:
    """K3c's Hopper kernel: dw f32 [kh, kw, Cin, Cout] <- the sum of the
    partials part [splits, kh*kw*Cin, Cout] over splits of ``per`` output
    rows each, for bf16 x [N, H, W, Cin] and dz [N, Ho, Wo, Cout], Cin and
    Cout multiples of 64 (``conv_wgrad`` checks and plans the splits)."""
    _check_aligned("conv_wgrad", x, dz)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = dw.shape
    _launch("conv_wgrad", _lib().mrssm_conv_wgrad_wgmma, x.device,
            x.data_ptr(), dz.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h,
            wd, cin, kh, kw, cout, *padding, part.shape[0], per)
    conv_wgrad_wgmma.launches += 1


for _fn in (conv_in_glu_fwd, in_glu_bwd_dz, conv_dgrad, conv_wgrad,
            conv_in_glu_fwd_wgmma, conv_dgrad_wgmma, conv_wgrad_wgmma):
    _fn.launches = 0
    ck.KERNELS[_fn.__name__] = _fn


# -- the op ----------------------------------------------------------------------


class ConvInGlu(torch.autograd.Function):
    """conv_in_glu with its backward: K2 forward; K3a, then K3b and K3c.
    Gradients come back in the inputs' dtypes (dw through f32, as the JAX
    op's)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, padding, eps):
        y, z, mean, var = conv_in_glu_fwd(
            x, w.to(x.dtype), scale.float(), bias.float(), padding, eps)
        ctx.save_for_backward(x, w, scale, bias, z, mean, var)
        ctx.padding, ctx.eps = padding, eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, scale, bias, z, mean, var = ctx.saved_tensors
        dz, dscale, dbias = in_glu_bwd_dz(
            dy.contiguous(), z, mean, var, scale.float(), bias.float(),
            ctx.eps)
        dx = conv_dgrad(dz, w, ctx.padding)
        dw = conv_wgrad(x, dz, w.shape[:2], ctx.padding)
        return (dx, dw.to(w.dtype), dscale.to(scale.dtype),
                dbias.to(bias.dtype), None, None)


def conv_in_glu(x, w, scale, bias, padding: Sequence[int],
                eps: float = 1e-5):
    """Fused stride-1 conv + train-mode InstanceNorm + GLU.

    x [N, H, W, Cin], w [kh, kw, Cin, Cout] (Cout even), scale and bias
    [Cout].  Returns (y [N, Ho, Wo, Cout/2], mean [N, Cout], var [N, Cout]);
    the per-instance stats carry no gradient (InstanceNorm buffers)."""
    return ConvInGlu.apply(x, w, scale, bias, _pair(padding), eps)


def conv_transpose_in_glu(x, w, scale, bias, padding: Sequence[int],
                          eps: float = 1e-5):
    """Fused stride-1 ConvTranspose + InstanceNorm + GLU, ``w`` in the
    ConvTranspose layout [kh, kw, Cin, Cout] (torch's ``ConvTranspose2d``
    weight (Cin, Cout, kh, kw) permuted by (2, 3, 0, 1)): the conv of x
    with the spatially flipped kernel and padding (kh-1-ph, kw-1-pw)."""
    ph, pw = _pair(padding)
    kh, kw = w.shape[0], w.shape[1]
    return conv_in_glu(x, torch.flip(w, (0, 1)), scale, bias,
                       (kh - 1 - ph, kw - 1 - pw), eps)


def reference_conv_in_glu(x, w, scale, bias, padding: Sequence[int],
                          eps: float = 1e-5):
    """The unfused composition: ``F.conv2d`` in x's dtype, then InstanceNorm
    (train) and GLU in f32.  Returns (y in x's dtype, mean, var f32)."""
    ph, pw = _pair(padding)
    z = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=(ph, pw)).permute(0, 2, 3, 1).float()
    mean = z.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((z * z).mean(dim=(1, 2), keepdim=True) - mean * mean,
                      min=0.0)
    a = scale.float() * torch.rsqrt(var + eps)
    zn = z * a + (bias.float() - mean * a)
    c2 = z.shape[-1] // 2
    y = zn[..., :c2] * torch.sigmoid(zn[..., c2:])
    return y.to(x.dtype), mean[:, 0, 0, :], var[:, 0, 0, :]
