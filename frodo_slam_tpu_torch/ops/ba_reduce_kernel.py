"""The backend's ray-edge normal equations: Hopper kernel, plain version, counter.

What it computes: for each directed ray edge e, over its N matched points,
with the edge's relative Sim(3) packed as ``scal[e] = [sR (row-major) | t]``:
P = sR Xj + t; the ray residual unit(P) - unit(Xi) and the distance residual
|P| - |Xi|, whitened by w0/sigma_ray and w0/sigma_dist and Huber-weighted
(k = 1.345); the 7x7 relative-pose Gram ``B = sum J^T W J`` and
``g = sum J^T W e``. The Jacobian rows are symbolic
(``ba_reduce_pallas.py:17-24``): ray rows ``[(I - rj rj^T)/n | -skew(rj) | 0]``,
distance row ``[rj^T | 0 | n]``. Norms are guarded by ``max(., 1e-12)``, so a
point with w0 = 0 (masked, or an all-zero pad point) contributes exactly 0.
Xj of row e is ``X[jj[e]]``, read from the window's pointmaps X (P, N, 3)
as they are; a row with ``active[e]`` False reads nothing and gets B = g = 0
exactly. The caller pushes B and g through AdjInv(T_i)
(``global_opt._kernel_ray_fn``).

Which TPU kernel it replaces: ``frodo_slam_tpu/ops/ba_reduce_pallas.py``
``_ray_reduce_kernel`` (pallas_call at :201), driven by
``ray_edge_systems_pallas``, which takes a gathered (E, 3, N) ``XjT`` and
streams every row; it carried its sums across a sequential grid in a
revisited VMEM block. Hopper blocks run in no order, so here each (point
chunk, edge) CTA reduces a partial row and the edge's last CTA to finish
(a per-edge ticket) sums the partial rows in chunk order: one launch, no
atomics on the sums, bitwise repeatable (``csrc/ray_edge_systems.cu``).

What bounds it: every GN iteration reads each live row's Xi and w0 once and
each distinct frame's points once, 16 and 12 bytes a point in f32, and does
about 260 operations a point (``FLOPS_PER_POINT``), below the card's 67
TFLOP/s f32 rate per byte at 3.35 TB/s: bytes. What the design does about
it: a producer warp streams tiles into a 4-stage shared-memory ring with
``cp.async.bulk`` so the loads never wait on the arithmetic; dead rows read
nothing; Xj comes through ``jj`` (rows of one frame meet its slab in L2);
the chunks are sized from the live rows (``n_active``) so that one wave of
live CTAs fills the card (:func:`ray_plan`).

Dispatch: a CPU tensor runs :func:`ray_edge_systems_plain`; a CUDA tensor
launches the kernel (f32 or f64, by the inputs' type) or raises. Nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import kernel_build

_SRC = kernel_build.CSRC / "ray_edge_systems.cu"
TILE_BYTES = 2048  # one channel row of a ring tile: 512 points in f32, 256 in f64
PLAIN_EDGE_CHUNK = 8  # edges per step of the plain version: bounds its (8, N, 4, 7) Jacobian
# Operations per point of the kernel's arithmetic, a multiply-add counted as
# two: P (18), both norms and guarded inverses (16), unit rays and residuals
# (10), whitening, Huber and weights (30), Dray (18), weighted rows and
# weighted residuals (19 + 4), B (55 multiply-adds) and g (19 multiply-adds).
FLOPS_PER_POINT = 18 + 16 + 10 + 30 + 18 + 19 + 4 + 2 * 55 + 2 * 19


def _rows(scal, XiT, XjT, eps):
    """Per-point Jacobian rows J (c, N, 4, 7), residuals (c, N, 4) of a chunk
    of edges, channel-major inputs."""
    sR = scal[:, :9].reshape(-1, 3, 3)
    P = torch.einsum("cab,cbn->can", sR, XjT) + scal[:, 9:12, None]  # (c, 3, N)
    n = torch.linalg.norm(P, dim=1)  # (c, N)
    ni = torch.linalg.norm(XiT, dim=1)
    a = P / torch.clamp(n, min=eps)[:, None]
    ri = XiT / torch.clamp(ni, min=eps)[:, None]
    n_inv = 1.0 / torch.clamp(n, min=eps)
    err = torch.cat([a - ri, (n - ni)[:, None]], dim=1).transpose(1, 2)  # (c, N, 4)
    a0, a1, a2 = a.unbind(1)
    z = torch.zeros_like(a0)
    d = lambda x, y, k: (float(k) - x * y) * n_inv  # noqa: E731
    J = torch.stack([
        torch.stack([d(a0, a0, 1), d(a0, a1, 0), d(a0, a2, 0), z, a2, -a1, z], -1),
        torch.stack([d(a0, a1, 0), d(a1, a1, 1), d(a1, a2, 0), -a2, z, a0, z], -1),
        torch.stack([d(a0, a2, 0), d(a1, a2, 0), d(a2, a2, 1), a1, -a0, z, z], -1),
        torch.stack([a0, a1, a2, z, z, z, n], -1),
    ], dim=2)  # (c, N, 4, 7)
    return J, err


def ray_edge_systems_plain(scal, XiT, w0, X, jj, active, *, sigma_ray: float, sigma_dist: float,
                           huber_k: float = 1.345):
    """Plain PyTorch version, on any device, in the inputs' type.

    scal (E, 12), XiT (E, 3, N), w0 (E, N), X (P, N, 3), jj (E,) int,
    active (E,) bool. Returns (B (E, 7, 7), g (E, 7)), B mirrored from its
    upper triangle like the kernel's; inactive rows exactly 0 (their jj is
    not used)."""
    E, _, N = XiT.shape
    dt, dev = XiT.dtype, XiT.device
    eps = 1e-12
    B = torch.zeros((E, 7, 7), dtype=dt, device=dev)
    g = torch.zeros((E, 7), dtype=dt, device=dev)
    for e0 in range(0, E, PLAIN_EDGE_CHUNK):
        sl = slice(e0, min(E, e0 + PLAIN_EDGE_CHUNK))
        live = active[sl]
        XjT = X[torch.where(live, jj[sl], 0).long()].transpose(1, 2)  # (c, 3, N)
        J, err = _rows(scal[sl], XiT[sl], XjT, eps)
        sr = w0[sl] * (1.0 / sigma_ray)
        sd = w0[sl] * (1.0 / sigma_dist)
        sw = torch.stack([sr, sr, sr, sd], dim=-1)  # (c, N, 4)
        x = torch.abs(sw * err)
        hub = torch.where(x <= huber_k, 1.0, huber_k / torch.clamp(x, min=eps))
        W = hub * sw * sw
        c = J.shape[0]
        Jf = J.reshape(c, N * 4, 7)
        Bc = (Jf * W.reshape(c, N * 4, 1)).transpose(1, 2) @ Jf
        Bc = torch.triu(Bc) + torch.triu(Bc, 1).transpose(1, 2)  # mirrored, as the kernel
        gc = torch.einsum("cki,ck->ci", Jf, (W * err).reshape(c, N * 4))
        B[sl] = torch.where(live[:, None, None], Bc, 0.0)
        g[sl] = torch.where(live[:, None], gc, 0.0)
    return B, g


def ray_plan(n_pts: int, n_active: int, slots: int, itemsize: int):
    """(chunks per row, tiles per chunk) of the kernel's grid: the rows'
    tiles of ``TILE_BYTES // itemsize`` points split so that ``n_active``
    live rows make at most ``slots`` CTAs (one wave on the card) and at
    least one chunk a row."""
    tiles = -(-n_pts // (TILE_BYTES // itemsize))
    if tiles == 0:
        return 1, 1
    want = max(1, min(tiles, slots // max(1, n_active)))
    per = -(-tiles // want)
    return -(-tiles // per), per


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    kernel_build.build(_SRC)
    lib = ctypes.CDLL(str(kernel_build.library_path(_SRC)))
    for name, scalar in (("ray_edge_systems_f32", ctypes.c_float),
                         ("ray_edge_systems_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [scalar] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.ray_edge_systems_slots.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ray_edge_systems_slots.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, f64: bool) -> int:
    """CTAs of the kernel resident on the card at once (SMs x per SM)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().ray_edge_systems_slots(int(f64), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"ray_edge_systems: occupancy query failed: cudaError {err}")
    return out.value


# per (device, stream): the per-edge tickets, zero between calls (the last
# CTA of each edge resets its own)
_TICKETS: dict = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device.index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 64),), dtype=torch.int32, device=device)
        _TICKETS[(device.index, stream)] = t
    return t


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


def _check(scal, XiT, w0, X, jj, active):
    dt, dev = XiT.dtype, XiT.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"ray_edge_systems: the kernel takes f32 or f64, got {dt}")
    if XiT.dim() != 3 or XiT.shape[1] != 3 or X.dim() != 3 or X.shape[2] != 3:
        raise ValueError(f"ray_edge_systems: XiT {tuple(XiT.shape)} is not (E, 3, N) or "
                         f"X {tuple(X.shape)} is not (P, N, 3)")
    E, _, N = XiT.shape
    want = {"scal": ((E, 12), dt), "w0": ((E, N), dt), "X": ((X.shape[0], N, 3), dt),
            "jj": ((E,), torch.int32), "active": ((E,), torch.bool)}
    for name, t in (("scal", scal), ("w0", w0), ("X", X), ("jj", jj), ("active", active)):
        shape, tdt = want[name]
        if tuple(t.shape) != shape or t.dtype != tdt or t.device != dev:
            raise ValueError(f"ray_edge_systems: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {shape} {tdt} on {dev}")
    for name, t in (("scal", scal), ("XiT", XiT), ("w0", w0), ("X", X), ("jj", jj), ("active", active)):
        if not t.is_contiguous():
            raise ValueError(f"ray_edge_systems: {name} is not contiguous")


def ray_edge_systems(scal, XiT, w0, X, jj, active, *, sigma_ray: float, sigma_dist: float,
                     huber_k: float = 1.345, n_active: Optional[int] = None):
    """Ray-edge systems on the card (CUDA tensors, f32 or f64, contiguous)
    or with the plain version (CPU tensors). Shapes as
    :func:`ray_edge_systems_plain`. ``n_active``: how many rows are live, as
    the host knows it (None: all E); it only sizes the chunks."""
    dev = XiT.device
    if dev.type == "cpu":
        return ray_edge_systems_plain(scal, XiT, w0, X, jj, active, sigma_ray=sigma_ray,
                                      sigma_dist=sigma_dist, huber_k=huber_k)
    if dev.type != "cuda":
        raise RuntimeError(f"ray_edge_systems: no kernel for device {dev}")
    _check(scal, XiT, w0, X, jj, active)
    E, _, N = XiT.shape
    dt = XiT.dtype
    itemsize = XiT.element_size()
    chunks, per = ray_plan(N, E if n_active is None else n_active,
                           _slots(dev.index, dt == torch.float64), itemsize)
    out = torch.empty((E * (56 + 35 * chunks),), dtype=dt, device=dev)  # B | g | partial rows
    B, g = out[: 49 * E].view(E, 7, 7), out[49 * E: 56 * E].view(E, 7)
    if E == 0:
        return B, g
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets(dev, stream, E)
    lib = _library()
    fn = lib.ray_edge_systems_f32 if dt == torch.float32 else lib.ray_edge_systems_f64
    args = (scal.data_ptr(), XiT.data_ptr(), w0.data_ptr(), X.data_ptr(), jj.data_ptr(),
            active.data_ptr(), B.data_ptr(), g.data_ptr(), out.data_ptr() + 56 * E * itemsize,
            tickets.data_ptr(), E, N, X.shape[0], chunks, per,
            1.0 / sigma_ray, 1.0 / sigma_dist, huber_k, stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"ray_edge_systems kernel launch failed: cudaError {err}")
    ray_edge_systems.launches += 1
    return B, g


ray_edge_systems.launches = 0
