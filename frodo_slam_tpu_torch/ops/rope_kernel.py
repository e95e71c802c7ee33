"""RoPE2D on the q and k of one attention: Hopper kernel, plain version, counter.

What it computes: the JAX package's ``apply_rope2d``
(``frodo_slam_tpu/models/layers.py:106``, the reference's RoPE2D fallback in
``croco/models/pos_embed.py:112-159``) on cos/sin tables that the forward
builds once (:func:`~frodo_slam_tpu_torch.models.layers.rope_tables`): a
(B, H, N, D) operand's first half of the head dim is rotated by the token's
y position, its second half by its x position, each with rotate-half.

Which TPU kernel it replaces: none. XLA fuses the rotation into the
attention's producers on the TPU; in eager PyTorch each of q and k of each
attention took some 35 launches (the tables rebuilt, then mul, neg, cat,
mul, add per half and a cat), 5,040 of a tracked frame's 8,293. The kernel
(``csrc/rope2d.cu``) rotates q and k of one attention in one launch, in
place, so the attention kernel reads the qkv split (or the cross-attention
projections) as it does without RoPE. It is bitwise equal to
:func:`rope2d_plain` in bf16 and f32: each product and the sum are rounded
where PyTorch's pointwise operators round them.

What bounds it: q and k read and written once and the tables read: at
(1, 16, 768, 64) bf16 6.3 MB, 1.9 us at 3.35 TB/s; launch latency is of the
same size.

Dispatch: CPU tensors take :func:`rope2d_plain` (written back into q and
k); CUDA tensors launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import kernel_build

_SRC = kernel_build.CSRC / "rope2d.cu"
_local = threading.local()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope2d_plain(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch RoPE2D on any device. ``t``: (B, H, N, D); ``table``:
    (B, N, 4, D/2) in ``t``'s type, cos_y, sin_y, cos_x, sin_x. Returns a new
    (B, H, N, D) tensor."""
    half = t.shape[-1] // 2
    cos_y, sin_y, cos_x, sin_x = (table[:, None, :, i] for i in range(4))
    y, x = t[..., :half], t[..., half:]
    y = y * cos_y + _rotate_half(y) * sin_y
    x = x * cos_x + _rotate_half(x) * sin_x
    return torch.cat([y, x], dim=-1)


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(kernel_build.library_path(_SRC)))
    fn = lib.rope2d_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def rope_vec(D: int, element_size: int, ptrs, strides) -> int:
    """Elements a thread moves as one vector: the largest power of two that
    fits in 16 bytes, divides the quarter D/4 and every element stride, and
    to whose size every pointer is aligned."""
    bits = D // 4 | 16 // element_size
    for s in strides:
        bits |= s
    for p in ptrs:
        bits |= p // element_size if p % element_size == 0 else 1
    return bits & -bits


def thread_launches() -> int:
    """Kernel launches made so far by the calling thread (the model's
    forwards read this for the ``model.rope_launches`` counter)."""
    return getattr(_local, "launches", 0)


def _strides(name: str, t: torch.Tensor, table: torch.Tensor, B: int, H: int, D: int):
    """Check ``t`` (B, H, N, D) and its table (B or 1, N, 4, D/2), and return
    their element strides (b, h, n) and (b, n, 4), 0 along a dim of size 1
    (never stepped, so it bounds no vector; a table of batch 1 serves every
    batch element)."""
    b, h, n, d = t.shape
    sb, sh, sn, sd = t.stride()
    if (b, h, d, sd) != (B, H, D, 1):
        raise ValueError(f"rope2d_: {name} {tuple(t.shape)} (strides {t.stride()}) is not "
                         f"({B}, {H}, N, {D}) with unit stride along the head dim")
    if table.dim() != 4 or table.shape[1:] != (n, 4, D // 2) or table.shape[0] not in (1, B) \
            or table.stride(-1) != 1:
        raise ValueError(f"rope2d_: {name}'s table {tuple(table.shape)} (strides {table.stride()}) is not "
                         f"({B}, {n}, 4, {D // 2}) with unit stride along its last dim")
    if table.dtype != t.dtype or table.device != t.device:
        raise ValueError(f"rope2d_: {name}'s table is {table.dtype} on {table.device}, "
                         f"{name} is {t.dtype} on {t.device}")
    tb, tn, t4, _ = table.stride()
    return ([sb if b > 1 else 0, sh if h > 1 else 0, sn if n > 1 else 0],
            [tb if table.shape[0] > 1 else 0, tn if n > 1 else 0, t4])


def rope2d_(q: torch.Tensor, k: torch.Tensor, table_q: torch.Tensor, table_k: torch.Tensor) -> None:
    """Rotate q (B, H, Nq, D) by ``table_q`` (B, Nq, 4, D/2) and k (B, H,
    Nk, D) by ``table_k``, in place: on the card (CUDA tensors, bf16 or f32,
    D % 4 == 0, any strides with unit stride along D) in one launch, on the
    CPU with :func:`rope2d_plain`. q and k must not overlap. A table of
    batch 1 serves every batch element."""
    if q.device.type == "cpu":
        q.copy_(rope2d_plain(q, table_q))
        k.copy_(rope2d_plain(k, table_k))
        return
    if q.device.type != "cuda":
        raise RuntimeError(f"rope2d_: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"rope2d_: q {tuple(q.shape)} and k {tuple(k.shape)} are not (B, H, N, D)")
    B, H, Nq, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rope2d_: the kernel takes bf16 or f32, got {q.dtype}")
    if D < 4 or D % 4:
        raise ValueError(f"rope2d_: head dim {D} is not a multiple of 4")
    if k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"rope2d_: k is {k.dtype} on {k.device}, q is {q.dtype} on {q.device}")
    sq, stq = _strides("q", q, table_q, B, H, D)
    sk, stk = _strides("k", k, table_k, B, H, D)
    ptrs = (q.data_ptr(), table_q.data_ptr(), k.data_ptr(), table_k.data_ptr())
    strides = sq + sk + stq + stk
    vec = rope_vec(D, q.element_size(), ptrs, strides)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rope2d_launch(*ptrs, 0 if q.dtype == torch.bfloat16 else 1, B, H, Nq, k.shape[2], D,
                                *strides, vec, stream)
    if err != 0:
        raise RuntimeError(f"rope2d kernel launch failed: error {err}")
    rope2d_.launches += 1
    _local.launches = thread_launches() + 1


rope2d_.launches = 0
