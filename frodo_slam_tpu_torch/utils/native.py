"""ctypes bindings of the host popcount kernels (``csrc/asmk_kernels.cpp``).

The library is built by ``g++`` into ``build/kernels/`` at the first call
(:func:`~frodo_slam_tpu_torch.ops.kernel_build.build_host`), never when this
module is imported. A failed build raises: nothing falls back to numpy. The
numpy plain versions live in :mod:`frodo_slam_tpu_torch.retrieval.asmk`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import kernel_build

_SRC = kernel_build.CSRC / "asmk_kernels.cpp"
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def library_path():
    return kernel_build.library_path(_SRC, kernel_build.HOST_FLAGS)


def build():
    """Compile the host kernels (see :mod:`..ops.kernel_build`)."""
    return kernel_build.build_host(_SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.hamming_cdist_packed.argtypes = [_u32p, _u32p, _f32p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_float]
    lib.binarize_and_pack_2d.argtypes = [_f32p, _u32p, ctypes.c_int64, ctypes.c_int64]
    lib.asmk_accumulate_word.argtypes = [_u32p, _u32p, _i64p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_float, ctypes.c_float, _f64p, _f64p]
    for fn in (lib.hamming_cdist_packed, lib.binarize_and_pack_2d, lib.asmk_accumulate_word):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ct)


def hamming_cdist_packed(a: np.ndarray, b: np.ndarray, dim_bits: int) -> np.ndarray:
    """(na, words) x (nb, words) packed rows -> (na, nb) f32 popcount(xor) / dim_bits."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"hamming_cdist_packed: shapes {a.shape} and {b.shape} do not fit")
    out = np.empty((a.shape[0], b.shape[0]), np.float32)
    _library().hamming_cdist_packed(_ptr(a, _u32p), _ptr(b, _u32p), _ptr(out, _f32p),
                                    a.shape[0], b.shape[0], a.shape[1], float(dim_bits))
    return out


def binarize_and_pack_2d(vecs: np.ndarray) -> np.ndarray:
    """(n, d) f32 -> (n, ceil(d / 32)) uint32, bit (v > 0), MSB-first."""
    vecs = np.ascontiguousarray(vecs, np.float32)
    if vecs.ndim != 2:
        raise ValueError(f"binarize_and_pack_2d: expected (n, d), got {vecs.shape}")
    n, d = vecs.shape
    out = np.empty((n, (d + 31) // 32), np.uint32)
    _library().binarize_and_pack_2d(_ptr(vecs, _f32p), _ptr(out, _u32p), n, d)
    return out


def asmk_accumulate_word(q: np.ndarray, vecs: np.ndarray, imids: np.ndarray, dim_bits: int,
                         sim_threshold: float, norm_factor: np.ndarray, scores: np.ndarray) -> None:
    """Add one query word's alpha = 3 ASMK similarities to ``scores`` in
    place: ``scores[imids[j]] += sim_j**3 / sqrt(norm_factor[imids[j]])``
    for every row j of ``vecs`` with ``sim_j >= sim_threshold``."""
    q = np.ascontiguousarray(q, np.uint32)
    vecs = np.ascontiguousarray(vecs, np.uint32)
    imids = np.ascontiguousarray(imids, np.int64)
    if vecs.ndim != 2 or q.shape != (vecs.shape[1],) or imids.shape != (vecs.shape[0],):
        raise ValueError(f"asmk_accumulate_word: q {q.shape}, vecs {vecs.shape}, "
                         f"imids {imids.shape} do not fit")
    # written in place: both must be the caller's own contiguous f64 arrays
    for name, arr in (("norm_factor", norm_factor), ("scores", scores)):
        if arr.dtype != np.float64 or not arr.flags.c_contiguous:
            raise ValueError(f"asmk_accumulate_word: {name} must be contiguous float64")
    if len(imids) and (imids.min() < 0 or imids.max() >= min(len(norm_factor), len(scores))):
        raise ValueError("asmk_accumulate_word: an image id is out of range")
    _library().asmk_accumulate_word(
        _ptr(q, _u32p), _ptr(vecs, _u32p), _ptr(imids, _i64p), vecs.shape[0], vecs.shape[1],
        float(dim_bits), float(sim_threshold), _ptr(norm_factor, _f64p), _ptr(scores, _f64p))
