"""Attention forward: Hopper flash-attention kernel, plain version, counter.

What it computes: ``o = softmax(q k^T * scale) v`` for q (B, H, Nq, D) and
k, v (B, H, Nk, D), non-causal, no bias, ``scale = 1/sqrt(D)``. The numerics
follow the JAX package's TPU kernel: s in f32 from the inputs' type, the
softmax in f32, the unnormalised p rounded to v's type before ``p v`` with
f32 accumulation, the output in q's type.

Which TPU kernel it replaces: JAX's library ``flash_attention``
(``jax.experimental.pallas.ops.tpu.flash_attention``, forward kernel
``_flash_attention_kernel_single_batch``), which the JAX package calls at
``frodo_slam_tpu/models/layers.py:151-161`` through ``_sdpa(impl="pallas")``.
Mosaic tiles it only when the token count has a block divisor that is a
multiple of 128 (768 tokens at 512x384, not 576 at 288x512), and the JAX
package falls back to XLA otherwise. This kernel takes any N, so the port
runs it for every attention, whatever ``attention_impl`` says: both values
compute this one function. No path of the JAX package differentiates the
model, so the library's backward kernels have no counterpart here.

The kernel (``csrc/flash_attention.cu``), bf16: one CTA per (batch x head,
64-query tile) with one consumer warpgroup and one producer warp. The
producer streams 64-key K and V tiles through a shared-memory ring with TMA
(4-D tensor maps over the caller's strides, 128-byte swizzle, zero fill past
N and D) and full/empty mbarriers; the consumers run S = Q K^T and
O += bf16(P) V as ``wgmma`` m64n64k16 (P from registers, V read MN-major
through the transpose bit) with the online softmax in f32 registers. The
tensor maps are encoded on the host per call from :func:`tma_plan`. f32
inputs (the tiny configurations) take an FMA variant. What bounds it: at
(1, 16, 768, 64) 2.4 GFLOP of bf16 dots against 6.3 MB moved, so the tensor
cores (2.4 us at 989 TFLOP/s).

Dispatch: a CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor
launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import kernel_build

_SRC = kernel_build.CSRC / "flash_attention.cu"
MAX_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device: f32 matmul, row max, exp, row
    sum, the unnormalised P rounded to v's type (JAX's placement), f32
    matmul, divided by the row sum, cast to q's type. (B, H, Nq, D) out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(kernel_build.library_path(_SRC)))
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def tma_plan(shape, strides, data_ptr: int, element_size: int = 2):
    """The 4-D tensor map (D, N, H, B) of one (B, H, N, D) operand with
    element ``strides``, or None where TMA cannot read the view as it is.

    TMA wants a 16-byte aligned base, unit stride along D, and every other
    byte stride a multiple of 16 (below 2^40). A dimension of size 1 is
    never stepped, so its stride is replaced by a legal one. Returns
    ``dict(dims=(D, N, H, B), strides=(n, h, b))`` with the strides in
    elements, as the kernel's host code encodes them."""
    B, H, N, D = shape
    sb, sh, sn, sd = strides
    if data_ptr % 16 or (sd != 1 and D > 1):
        return None
    out = []
    for size, st in ((N, sn), (H, sh), (B, sb)):
        nbytes = st * element_size
        if size > 1 and (nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40):
            return None
        out.append(st)
    # a never-stepped dimension gets the contiguous stride of everything inside it
    inner = -(-D * element_size // 16) * 16 // element_size
    for i, size in enumerate((N, H, B)):
        if size == 1:
            out[i] = inner
        inner = max(inner, abs(out[i]) * size)
    return dict(dims=(D, N, H, B), strides=tuple(out))


def _tma_operand(t: torch.Tensor):
    """``t`` and its plan; where TMA cannot read ``t`` as it is, a copy into
    a buffer whose rows are padded to 16 bytes (a view of its first D
    columns) and that copy's plan."""
    plan = tma_plan(t.shape, t.stride(), t.data_ptr(), t.element_size())
    if plan is None:
        B, H, N, D = t.shape
        buf = t.new_empty((B, H, N, -(-D // 8) * 8))
        buf[..., :D] = t
        t = buf[..., :D]
        plan = tma_plan(t.shape, t.stride(), t.data_ptr(), t.element_size())
    return t, plan


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on the card (CUDA tensors, bf16 or f32) or with the plain
    version (CPU tensors). q (B, H, Nq, D), k and v (B, H, Nk, D), any
    strides with unit stride along D. Returns (B, H, Nq, D) in q's type; on
    the card a view of a contiguous (B, Nq, H, D) buffer.

    bf16 operands are read in place by TMA where :func:`tma_plan` accepts
    their strides and base (every view the model makes: the qkv split, the
    cross-attention projections, the RoPE outputs); any other view is first
    copied into a buffer with 16-byte rows."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} is not (B, H, N, D)")
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: the kernel takes bf16 or f32, got {q.dtype}")
    if D > MAX_HEAD_DIM or D < 1:
        raise ValueError(f"flash_attention: head dim {D} outside 1..{MAX_HEAD_DIM}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, H, Nk, D):
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} != {(B, H, Nk, D)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
    if Nk < 1:
        raise ValueError("flash_attention: no keys")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        (q, pq), (k, pk), (v, pv) = (_tma_operand(t) for t in (q, k, v))
        strides = [s for p in (pq, pk, pv) for s in reversed(p["strides"])]
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if bf16 else 1,
            B, H, Nq, Nk, D, *strides, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
