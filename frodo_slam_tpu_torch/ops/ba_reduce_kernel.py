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
The caller pushes B and g through AdjInv(T_i) (``global_opt._kernel_ray_fn``).

Which TPU kernel it replaces: ``frodo_slam_tpu/ops/ba_reduce_pallas.py``
``_ray_reduce_kernel`` (pallas_call at :201), driven by
``ray_edge_systems_pallas``. The TPU kernel carried its sums across a
sequential grid in a revisited VMEM block; Hopper blocks run in no order, so
the port is two passes (``csrc/ray_edge_systems.cu``): per (point chunk,
edge) one CTA reduces its points into a partial row, then one small launch
sums each edge's partial rows in a fixed order.

What bounds it: every GN iteration reads each point once, Xi, Xj and w0,
28 bytes in f32 (56 in f64), and does about 260 operations on them (see
``FLOPS_PER_POINT``), below the card's 67 TFLOP/s f32 rate per byte at
3.35 TB/s: it is bound by bytes. What the design does about it: the 35 sums
stay in registers, so the only traffic is one coalesced streaming read of
the inputs; no intermediate touches device memory. It uses no TMA, no
tensor cores (the per-point work is 7-vector outer products, not a matrix
product) and re-reads Xj from the materialised ``XjT`` instead of indexing
the pointmaps by edge; those are later work.

Dispatch: a CPU tensor runs :func:`ray_edge_systems_plain`; a CUDA tensor
launches the kernel (f32 or f64, by the inputs' type) or raises. Nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernel_build

_SRC = kernel_build.CSRC / "ray_edge_systems.cu"
CHUNK = 4096  # points per CTA of the first pass (16 per thread)
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


def ray_edge_systems_plain(scal, XiT, XjT, w0, *, sigma_ray: float, sigma_dist: float,
                           huber_k: float = 1.345):
    """Plain PyTorch version, on any device, in the inputs' type.

    scal (E, 12), XiT/XjT (E, 3, N), w0 (E, N). Returns (B (E, 7, 7),
    g (E, 7)), B mirrored from its upper triangle like the kernel's."""
    E, _, N = XiT.shape
    dt, dev = XiT.dtype, XiT.device
    eps = 1e-12
    B = torch.zeros((E, 7, 7), dtype=dt, device=dev)
    g = torch.zeros((E, 7), dtype=dt, device=dev)
    for e0 in range(0, E, PLAIN_EDGE_CHUNK):
        sl = slice(e0, min(E, e0 + PLAIN_EDGE_CHUNK))
        J, err = _rows(scal[sl], XiT[sl], XjT[sl], eps)
        sr = w0[sl] * (1.0 / sigma_ray)
        sd = w0[sl] * (1.0 / sigma_dist)
        sw = torch.stack([sr, sr, sr, sd], dim=-1)  # (c, N, 4)
        x = torch.abs(sw * err)
        hub = torch.where(x <= huber_k, 1.0, huber_k / torch.clamp(x, min=eps))
        W = hub * sw * sw
        c = J.shape[0]
        Jf = J.reshape(c, N * 4, 7)
        Bc = (Jf * W.reshape(c, N * 4, 1)).transpose(1, 2) @ Jf
        B[sl] = torch.triu(Bc) + torch.triu(Bc, 1).transpose(1, 2)  # mirrored, as the kernel
        g[sl] = torch.einsum("cki,ck->ci", Jf, (W * err).reshape(c, N * 4))
    return B, g


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    kernel_build.build(_SRC)
    lib = ctypes.CDLL(str(kernel_build.library_path(_SRC)))
    for name, scalar in (("ray_edge_systems_f32", ctypes.c_float),
                         ("ray_edge_systems_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [scalar] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


def ray_edge_systems(scal, XiT, XjT, w0, *, sigma_ray: float, sigma_dist: float,
                     huber_k: float = 1.345):
    """Ray-edge systems on the card (CUDA tensors, f32 or f64) or with the
    plain version (CPU tensors). Shapes as :func:`ray_edge_systems_plain`."""
    if XiT.device.type == "cpu":
        return ray_edge_systems_plain(scal, XiT, XjT, w0, sigma_ray=sigma_ray,
                                      sigma_dist=sigma_dist, huber_k=huber_k)
    if XiT.device.type != "cuda":
        raise RuntimeError(f"ray_edge_systems: no kernel for device {XiT.device}")
    dt = XiT.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"ray_edge_systems: the kernel takes f32 or f64, got {dt}")
    if XiT.dim() != 3 or XiT.shape[1] != 3:
        raise ValueError(f"ray_edge_systems: XiT {tuple(XiT.shape)} is not (E, 3, N)")
    E, _, N = XiT.shape
    want = {"scal": (E, 12), "XjT": (E, 3, N), "w0": (E, N)}
    for name, t in (("scal", scal), ("XjT", XjT), ("w0", w0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ray_edge_systems: {name} {tuple(t.shape)} != {want[name]}")
        if t.dtype != dt or t.device != XiT.device:
            raise ValueError(f"ray_edge_systems: {name} is {t.dtype} on {t.device}, "
                             f"XiT is {dt} on {XiT.device}")
    scal, XiT, XjT, w0 = (t.contiguous() for t in (scal, XiT, XjT, w0))
    chunks = max(1, -(-N // CHUNK))
    partial = torch.empty((E, chunks, 35), dtype=dt, device=XiT.device)
    # the second pass writes every entry of B and g; with no points it does not run
    alloc = torch.empty if N else torch.zeros
    B = alloc((E, 7, 7), dtype=dt, device=XiT.device)
    g = alloc((E, 7), dtype=dt, device=XiT.device)
    lib = _library()
    fn = lib.ray_edge_systems_f32 if dt == torch.float32 else lib.ray_edge_systems_f64
    with torch.cuda.device(XiT.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(scal.data_ptr(), XiT.data_ptr(), XjT.data_ptr(), w0.data_ptr(),
                 partial.data_ptr(), B.data_ptr(), g.data_ptr(), E, N, CHUNK,
                 1.0 / sigma_ray, 1.0 / sigma_dist, huber_k, stream)
    if err != 0:
        raise RuntimeError(f"ray_edge_systems kernel launch failed: cudaError {err}")
    ray_edge_systems.launches += 1
    return B, g


ray_edge_systems.launches = 0
