"""The backend's calibrated edge normal equations: Hopper kernel, plain version, counter.

What it computes: for each directed edge e of the calibrated window solve,
over its N points, with the edge's relative Sim(3) ``T_ij = T_i^-1 T_j`` of
the window poses T (P, 8) at ``ii[e]`` and ``jj[e]``, applied as [sR | t]
(:func:`~.lie.sim3_rel_sRt`), and the intrinsics ``intr = [fx, fy, cx,
cy]``: P = sR Xj + t in frame i; the pixel + log-depth residual ``[u -
u_t, v - v_t, log P_z - log z_i]`` against the matched pixel ``idx`` of
frame i; a point counts where both depths exceed ``depth_eps`` and (u, v)
lies inside the pixel border; sqrt-weights w0/sigma_pixel and
w0/sigma_depth, Huber-weighted (k = :data:`~.robust.HUBER_K`); the 7x7 relative-pose Gram ``B
= sum J^T W J`` and ``g = sum J^T W e`` with Jacobian rows ``[d_r, P x
d_r, d_r . P]``, d_r the rows of d[u, v, log z]/dP (the reference's
calib_proj_kernel, gn_kernels.cu:2295-2608). Xi enters through its depth
z_i = XiT[e, 2] alone. Xj of row e is ``X[jj[e]]``, read from the window's
pointmaps X (P, N, 3) as they are; a row with ``active[e]`` False reads
nothing (nor its ii and jj) and gets B = g = 0 exactly. The caller pushes
B and g through AdjInv(T_i) (``global_opt._edge_systems``).

Which TPU kernel it replaces: none. The JAX package reduces these edges with
XLA (``frodo_slam_tpu/slam/global_opt.py`` ``_calib_edge_system``), and the
port ran them as chunked tensor code, :func:`calib_edge_systems_plain`: some
90 launches a chunk of ten edges, among them a (10, N, 3, 8) concatenation
of 189 MB at 384x512 and a weighted copy of it, every GN iteration.

What bounds it: every GN iteration reads each live row's z_i, w0 and idx
once and each distinct frame's points once, 12 and 12 bytes a point in f32,
and does about 240 operations a point (:data:`FLOPS_PER_POINT`), below the
card's 67 TFLOP/s f32 rate per byte at 3.35 TB/s: bytes, the arithmetic
close behind. What the design does about it (``csrc/calib_edge_systems.cu``):
one launch of (chunk, edge) CTAs, each thread loading its next points before
it computes them; each CTA forms its edge's relative pose from the two poses
(some 90 eager launches of tiny tensors a GN iteration when done outside);
dead rows read nothing; Xj comes through ``jj``; the 35 sums stay in
registers and each edge's last CTA (a per-edge ticket) sums the partial rows
in chunk order, so two calls are bitwise equal; the chunks are sized from
the live rows (``n_active``, :func:`calib_plan`) so that one wave of live
CTAs fills the card.

Dispatch: a CPU tensor runs :func:`calib_edge_systems_plain`; a CUDA tensor
launches the kernel (f32 or f64, by the inputs' type) or raises. Nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import kernel_build, lie
from .ba_reduce_kernel import TILE_BYTES, edge_tickets, ray_plan
from .normal_eqs import edge_chunks, reduce_rel_systems
from .robust import HUBER_K, huber

_SRC = kernel_build.CSRC / "calib_edge_systems.cu"
# Operations per counted point of the kernel's arithmetic, a multiply-add
# counted as two (the relative pose, ~110 an edge and CTA, left out): P
# (18), depth tests (2), reciprocal, projection and pixel
# (7), border tests (4), matched pixel (4), residuals with two logs (6),
# sqrt-weights, Huber and weights (20), D (6), the Jacobian rows' cross and
# dot products (19), weighted rows and weighted residuals (16 + 3), B (52
# multiply-adds) and g (16 multiply-adds).
FLOPS_PER_POINT = 18 + 2 + 7 + 4 + 4 + 6 + 20 + 6 + 19 + 16 + 3 + 2 * 52 + 2 * 16


def calib_edge_systems_plain(T, intr, XiT, w0, X, ii, jj, idx, active, *, img_hw, sigma_pixel: float,
                             sigma_depth: float, pixel_border: float, depth_eps: float):
    """Plain PyTorch version, on any device, in the inputs' type: chunked
    tensor code over :data:`~.normal_eqs.EDGE_CHUNK_POINTS` points a step.

    T (P, 8), intr (4,), XiT (E, 3, N), w0 (E, N), X (P, N, 3), ii and jj
    (E,) int, idx (E, N) int, active (E,) bool; ``img_hw`` (height, width).
    Returns (B (E, 7, 7), g (E, 7)), B mirrored from its upper triangle like
    the kernel's; inactive rows exactly 0 (their ii and jj are not used)."""
    height, width = img_hw
    E, _, N = XiT.shape
    dt, dev = XiT.dtype, XiT.device
    fx, fy, cx, cy = intr.unbind()
    B = torch.zeros((E, 7, 7), dtype=dt, device=dev)
    g = torch.zeros((E, 7), dtype=dt, device=dev)
    for sl in edge_chunks(E, N):
        live = active[sl]
        i, j = torch.where(live, ii[sl], 0).long(), torch.where(live, jj[sl], 0).long()
        sRt = lie.sim3_rel_sRt(T[i], T[j])
        P = torch.einsum("cab,cnb->cna", sRt[:, :9].reshape(-1, 3, 3), X[j]) + sRt[:, None, 9:12]  # frame i
        zi = XiT[sl, 2]
        valid_z = (P[..., 2] > depth_eps) & (zi > depth_eps)
        z_inv = torch.where(valid_z, 1.0 / torch.where(valid_z, P[..., 2], 1.0), 0.0)
        x_div_z = P[..., 0] * z_inv
        y_div_z = P[..., 1] * z_inv
        u = fx * x_div_z + cx
        v = fy * y_div_z + cy
        ids = idx[sl].long()
        u_t = (ids % width).to(dt)
        v_t = torch.div(ids, width, rounding_mode="floor").to(dt)
        valid_u = (u > pixel_border) & (u < width - 1 - pixel_border)
        valid_v = (v > pixel_border) & (v < height - 1 - pixel_border)
        zj_log = torch.where(valid_z, torch.log(torch.where(valid_z, P[..., 2], 1.0)), 0.0)
        zi_log = torch.where(valid_z, torch.log(torch.clamp(zi, min=depth_eps)), 0.0)
        err = torch.stack([u - u_t, v - v_t, zj_log - zi_log], dim=-1)  # (c, N, 3)
        okf = (valid_u & valid_v & valid_z).to(dt) * w0[sl]
        sw_pix = okf / sigma_pixel
        sqrt_w = torch.stack([sw_pix, sw_pix, okf / sigma_depth], dim=-1)
        w = huber(sqrt_w * err) * sqrt_w * sqrt_w
        # D = d[u, v, log z]/dP (gn_kernels.cu:2486-2545)
        zeros = torch.zeros_like(z_inv)
        D = torch.stack([
            torch.stack([fx * z_inv, zeros, -fx * x_div_z * z_inv], dim=-1),
            torch.stack([zeros, fy * z_inv, -fy * y_div_z * z_inv], dim=-1),
            torch.stack([zeros, zeros, z_inv], dim=-1),
        ], dim=-2)  # (c, N, 3, 3)
        Bc, gc = reduce_rel_systems(D, w, err, P)
        Bc = torch.triu(Bc) + torch.triu(Bc, 1).transpose(1, 2)  # mirrored, as the kernel
        B[sl] = torch.where(live[:, None, None], Bc, 0.0)
        g[sl] = torch.where(live[:, None], gc, 0.0)
    return B, g


def calib_plan(n_pts: int, n_active: int, slots: int):
    """(chunks per row, points per chunk) of the kernel's grid: a row's
    points in whole tiles of an f32 ray row (512 points), split so that
    ``n_active`` live rows make at most ``slots`` CTAs (one wave on the
    card) and at least one chunk a row (:func:`~.ba_reduce_kernel.ray_plan`)."""
    chunks, per = ray_plan(n_pts, n_active, slots, 4)
    return chunks, per * (TILE_BYTES // 4)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    kernel_build.build(_SRC)
    lib = ctypes.CDLL(str(kernel_build.library_path(_SRC)))
    for name, scalar in (("calib_edge_systems_f32", ctypes.c_float),
                         ("calib_edge_systems_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [scalar] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.calib_edge_systems_slots.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.calib_edge_systems_slots.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, f64: bool) -> int:
    """CTAs of the kernel resident on the card at once (SMs x per SM)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().calib_edge_systems_slots(int(f64), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"calib_edge_systems: occupancy query failed: cudaError {err}")
    return out.value


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


def _check(T, intr, XiT, w0, X, ii, jj, idx, active):
    dt, dev = XiT.dtype, XiT.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"calib_edge_systems: the kernel takes f32 or f64, got {dt}")
    if XiT.dim() != 3 or XiT.shape[1] != 3 or X.dim() != 3 or X.shape[2] != 3:
        raise ValueError(f"calib_edge_systems: XiT {tuple(XiT.shape)} is not (E, 3, N) or "
                         f"X {tuple(X.shape)} is not (P, N, 3)")
    E, _, N = XiT.shape
    P = X.shape[0]
    want = {"T": ((P, 8), dt), "intr": ((4,), dt), "w0": ((E, N), dt), "X": ((P, N, 3), dt),
            "ii": ((E,), torch.int32), "jj": ((E,), torch.int32), "idx": ((E, N), torch.int32),
            "active": ((E,), torch.bool)}
    named = (("T", T), ("intr", intr), ("w0", w0), ("X", X), ("ii", ii), ("jj", jj), ("idx", idx),
             ("active", active))
    for name, t in named:
        shape, tdt = want[name]
        if tuple(t.shape) != shape or t.dtype != tdt or t.device != dev:
            raise ValueError(f"calib_edge_systems: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {shape} {tdt} on {dev}")
    for name, t in named + (("XiT", XiT),):
        if not t.is_contiguous():
            raise ValueError(f"calib_edge_systems: {name} is not contiguous")


def calib_edge_systems(T, intr, XiT, w0, X, ii, jj, idx, active, *, img_hw, sigma_pixel: float,
                       sigma_depth: float, pixel_border: float, depth_eps: float,
                       n_active: Optional[int] = None):
    """Calibrated edge systems on the card (CUDA tensors, f32 or f64,
    contiguous) or with the plain version (CPU tensors). Shapes as
    :func:`calib_edge_systems_plain`. ``n_active``: how many rows are live,
    as the host knows it (None: all E); it only sizes the chunks."""
    dev = XiT.device
    kw = dict(img_hw=img_hw, sigma_pixel=sigma_pixel, sigma_depth=sigma_depth, pixel_border=pixel_border,
              depth_eps=depth_eps)
    if dev.type == "cpu":
        return calib_edge_systems_plain(T, intr, XiT, w0, X, ii, jj, idx, active, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"calib_edge_systems: no kernel for device {dev}")
    _check(T, intr, XiT, w0, X, ii, jj, idx, active)
    E, _, N = XiT.shape
    dt = XiT.dtype
    itemsize = XiT.element_size()
    chunks, pts = calib_plan(N, E if n_active is None else n_active, _slots(dev.index, dt == torch.float64))
    out = torch.empty((E * (56 + 35 * chunks),), dtype=dt, device=dev)  # B | g | partial rows
    B, g = out[: 49 * E].view(E, 7, 7), out[49 * E: 56 * E].view(E, 7)
    if E == 0:
        return B, g
    height, width = img_hw
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = edge_tickets(dev, stream, E)
    lib = _library()
    fn = lib.calib_edge_systems_f32 if dt == torch.float32 else lib.calib_edge_systems_f64
    args = (T.data_ptr(), intr.data_ptr(), XiT.data_ptr(), w0.data_ptr(), X.data_ptr(), ii.data_ptr(),
            jj.data_ptr(), idx.data_ptr(), active.data_ptr(), B.data_ptr(), g.data_ptr(),
            out.data_ptr() + 56 * E * itemsize, tickets.data_ptr(), E, N, X.shape[0], chunks, pts, width,
            1.0 / sigma_pixel, 1.0 / sigma_depth, pixel_border, width - 1 - pixel_border,
            height - 1 - pixel_border, depth_eps, HUBER_K, stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"calib_edge_systems kernel launch failed: cudaError {err}")
    calib_edge_systems.launches += 1
    return B, g


calib_edge_systems.launches = 0
