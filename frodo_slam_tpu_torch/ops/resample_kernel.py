"""A camera frame's resize, centre crop and ImgNorm: Hopper kernel, plain twin.

What it computes: :func:`~frodo_slam_tpu_torch.data.image.resize_img`'s
network input, bitwise. That is the reference's recipe
(``mast3r_utils.py:369-460``): the frame quantised as ``np.uint8(img *
255)``, resized by PIL (``ImagingResample``, ``libImaging/Resample.c``) with
Lanczos when shrinking and bicubic otherwise, centre-cropped and normalised
as ``(u / 255 - 0.5) / 0.5`` in f32. PIL's resampler, as it is done here:

1. a coefficient table per axis (:func:`coeffs`), in double on the host from
   libm's ``sin`` as PIL computes it, normalised per output index, then in
   22-bit fixed point;
2. a horizontal pass to a uint8 image: ``clip((2^21 + sum u k) >> 22)``,
   where the sum runs over the taps in order in int32;
3. a vertical pass over that image, with the same formula.

PIL skips a pass whose axis keeps its size; an identity table (one tap of
2^22 per index) gives the same bytes here.

Which TPU kernel it replaces: none. The JAX package and the port resized
every frame with PIL on the calling thread (~14 ms of host time at 640x480,
with the card idle). Here the f32 frame is uploaded once and two launches
(``csrc/resample.cu``) do the rest: quantise and the horizontal pass, then
the vertical pass, the crop, ImgNorm and the portrait transpose.

What bounds it: the f32 frame read once and the f32 network input written
once: 6.05 MB at 480x640 -> 384x512, 1.8 us at 3.35 TB/s; two launches.

Dispatch (:func:`resample`): CPU tensors take
:func:`resize_normalize_plain`; CUDA tensors launch the kernel or raise.
Nothing falls back. The tables are built once an (input size, output size,
filter) and uploaded once a device; nothing is cached by frame.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..data.image import resize_geometry
from . import kernel_build

_SRC = kernel_build.CSRC / "resample.cu"
PRECISION_BITS = 22  # PIL's 8-bit path: 32 - 8 - 2
LANCZOS, BICUBIC = 0, 1
_SUPPORT = {LANCZOS: 3.0, BICUBIC: 2.0}


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {LANCZOS: _lanczos, BICUBIC: _bicubic}


@functools.lru_cache(maxsize=None)
def coeffs(in_size: int, out_size: int, filt: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's table for one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): ``bounds`` (out, 2) int32, the first input
    index and the number of taps of each output index, and ``kk`` (out,
    ksize) int32 fixed-point weights, 0 past each row's taps. An axis that
    keeps its size gets the identity (PIL skips its pass)."""
    if in_size == out_size:
        return (np.stack([np.arange(out_size), np.ones(out_size, np.int64)], 1).astype(np.int32),
                np.full((out_size, 1), 1 << PRECISION_BITS, np.int32))
    scale = float(in_size) / out_size  # PIL: (double)(in1 - in0) / outSize, in0 = 0
    filterscale = max(scale, 1.0)
    support = _SUPPORT[filt] * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    fn = _FILTERS[filt]
    ss = 1.0 / filterscale
    bounds = np.zeros((out_size, 2), np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
        bounds[xx] = (xmin, xmax)
    return bounds, kk


class Plan(NamedTuple):
    """One frame shape's work: the resized size (H, W), the crop's top-left
    (y0, x0) and size (h, w), the filter, and the input rows the crop's
    vertical taps read, [r0, r1)."""
    resized_hw: Tuple[int, int]
    crop_yx: Tuple[int, int]
    out_hw: Tuple[int, int]
    filt: int
    rows: Tuple[int, int]


@functools.lru_cache(maxsize=None)
def plan(in_hw: Tuple[int, int], size: int = 512, square_ok: bool = False) -> Plan:
    """:func:`resize_img`'s resize and crop of a frame of shape ``in_hw``
    (``data.image.resize_geometry``)."""
    H1, W1 = in_hw
    geo = resize_geometry(H1, W1, size, square_ok)
    (W, H), (left, top, right, bottom) = geo.size_wh, geo.crop
    filt = LANCZOS if geo.lanczos else BICUBIC
    by, _ = coeffs(H1, H, filt)
    used = by[top:bottom]
    rows = (int(used[:, 0].min()), int((used[:, 0] + used[:, 1]).max())) if bottom > top else (0, 0)
    return Plan((H, W), (top, left), (bottom - top, right - left), filt, rows)


def quantise_plain(img: torch.Tensor) -> torch.Tensor:
    """``np.uint8(img * 255)`` of an f32 frame (an f32 product, then
    truncation); a uint8 frame is taken as already quantised."""
    if img.dtype == torch.uint8:
        return img
    return (img * 255).to(torch.int32).to(torch.uint8)


def normalize_plain(u: torch.Tensor) -> torch.Tensor:
    """ImgNorm of uint8 values, ``(u / 255 - 0.5) / 0.5`` in f32."""
    return (u.to(torch.float32) / 255.0 - 0.5) / 0.5


def _pass_plain(u: torch.Tensor, bounds: np.ndarray, kk: np.ndarray, dim: int) -> torch.Tensor:
    """One PIL pass along ``dim`` of the uint8 image ``u`` for the table rows
    given: the taps summed in order in int32, rounded, shifted and clipped."""
    lim = u.shape[dim] - 1
    k = torch.from_numpy(kk).to(u.device)
    idx0 = torch.from_numpy(bounds[:, 0].astype(np.int64)).to(u.device)
    shape = [1] * u.dim()
    shape[dim] = -1
    acc = torch.full([len(bounds) if d == dim else n for d, n in enumerate(u.shape)],
                     1 << (PRECISION_BITS - 1), dtype=torch.int32, device=u.device)
    for t in range(kk.shape[1]):  # taps past a row's count have weight 0
        taps = torch.index_select(u, dim, (idx0 + t).clamp(max=lim)).to(torch.int32)
        acc += taps * k[:, t].reshape(shape)
    return (acc >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def resize_normalize_plain(img: torch.Tensor, p: Plan, transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel on any device: the (H, W, 3) f32 or
    uint8 frame to the (1, h, w, 3) f32 network input of plan ``p`` ((1, w,
    h, 3) when ``transpose``)."""
    H1, W1 = img.shape[:2]
    (H, W), (y0, x0), (h, w), (r0, r1) = p.resized_hw, p.crop_yx, p.out_hw, p.rows
    bx, kx = coeffs(W1, W, p.filt)
    by, ky = coeffs(H1, H, p.filt)
    u = quantise_plain(img[r0:r1])
    tmp = _pass_plain(u, bx[x0:x0 + w], kx[x0:x0 + w], 1)
    rows = by[y0:y0 + h].copy()
    rows[:, 0] -= r0
    out = normalize_plain(_pass_plain(tmp, rows, ky[y0:y0 + h], 0))
    return (out.transpose(0, 1) if transpose else out)[None].contiguous()


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(kernel_build.library_path(_SRC)))
    fn = lib.resample_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


_device_tables = {}  # (device, in size, out size, filter) -> (bounds, kk) on the device


def _tables(device: torch.device, in_size: int, out_size: int, filt: int):
    key = (device, in_size, out_size, filt)
    t = _device_tables.get(key)
    if t is None:
        t = tuple(torch.from_numpy(a).to(device) for a in coeffs(in_size, out_size, filt))
        _device_tables[key] = t
    return t


def resize_normalize(img: torch.Tensor, size: int = 512, transpose: bool = False,
                     square_ok: bool = False) -> torch.Tensor:
    """The (1, h, w, 3) f32 network input of a frame ``img`` (H, W, 3), f32
    in [0, 1] or uint8 already quantised, as ``resize_img(img, size,
    square_ok)["img"]`` gives it, transposed to (1, w, h, 3) when
    ``transpose`` (:func:`resample` of the frame's :func:`plan`)."""
    if img.dim() != 3:
        raise ValueError(f"resize_normalize: the frame {tuple(img.shape)} is not (H, W, 3)")
    return resample(img, plan(tuple(img.shape[:2]), size, square_ok), transpose)


def resample(img: torch.Tensor, p: Plan, transpose: bool = False) -> torch.Tensor:
    """Plan ``p`` on the frame ``img`` (H, W, 3), f32 or uint8: on the card
    (a contiguous CUDA tensor) in two launches on the current stream, on the
    CPU with :func:`resize_normalize_plain`."""
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"resample: the frame {tuple(img.shape)} is not (H, W, 3)")
    if img.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"resample: the frame is {img.dtype}, not f32 or uint8")
    if img.device.type == "cpu":
        return resize_normalize_plain(img, p, transpose)
    if img.device.type != "cuda":
        raise RuntimeError(f"resample: no kernel for device {img.device}")
    if not img.is_contiguous():
        raise ValueError(f"resample: the frame (strides {img.stride()}) is not contiguous")
    H1, W1 = img.shape[:2]
    (H, W), (y0, x0), (h, w), (r0, r1) = p.resized_hw, p.crop_yx, p.out_hw, p.rows
    bx, kx = _tables(img.device, W1, W, p.filt)
    by, ky = _tables(img.device, H1, H, p.filt)
    tmp = torch.empty((r1 - r0, w, 3), dtype=torch.uint8, device=img.device)
    out = torch.empty((1, w, h, 3) if transpose else (1, h, w, 3), dtype=torch.float32, device=img.device)
    # element strides of the crop's rows and columns in ``out``
    so_r, so_c = (3, 3 * h) if transpose else (3 * w, 3)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.resample_launch(img.data_ptr(), int(img.dtype == torch.uint8), H1, W1, tmp.data_ptr(),
                                  r0, r1 - r0, x0, w, bx.data_ptr(), kx.data_ptr(), kx.shape[1],
                                  by.data_ptr(), ky.data_ptr(), ky.shape[1], y0, h, out.data_ptr(),
                                  so_r, so_c, stream)
    if err != 0:
        raise RuntimeError(f"resample kernel launch failed: error {err}")
    resample.launches += 2
    return out


resample.launches = 0
