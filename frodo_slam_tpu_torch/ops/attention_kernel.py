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

The kernel (``csrc/flash_attention.cu``): one CTA per (batch x head,
64-query tile), K/V tiles of 64 keys in shared memory, ``mma.sync``
m16n8k16 bf16 with f32 accumulators, the online softmax in f32 registers, P
rounded to bf16 in registers and fed back as the A operand of P V. f32
inputs (the tiny configurations) take an FMA variant of the same tiling.
What bounds it: at (1, 16, 768, 64) 2.4 GFLOP of bf16 dots against 6.3 MB
moved, so the tensor cores (2.4 us at 989 TFLOP/s); this first version uses
neither wgmma nor TMA.

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
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte rows: the bf16 kernel's vector loads need D % 8 == 0, token,
    head and batch strides in multiples of 8 and an aligned base."""
    return (t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on the card (CUDA tensors, bf16 or f32) or with the plain
    version (CPU tensors). q (B, H, Nq, D), k and v (B, H, Nk, D), any
    strides with unit stride along D. Returns (B, H, Nq, D) in q's type; on
    the card a view of a contiguous (B, Nq, H, D) buffer."""
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
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    vec = int(bf16 and _vec_ok(k) and _vec_ok(v))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if bf16 else 1,
            B, H, Nq, Nk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(D), vec, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
