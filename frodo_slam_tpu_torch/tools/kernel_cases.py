"""Seeded inputs and device timers for the hand-written kernels.

Shared by ``chip_smoke.py`` and ``kernel_ab.py``, so both time the same
cases the same way. Every tensor is made on ``device`` from a seeded
generator; the timers need a card.

Refine cases (descriptors (1, h, w, 24), one query per pixel of the frame-2
raster, as ``ops/matching.py`` hands them to the kernel):

- ``identity_pm20``: unit random descriptors; query k is a noisy copy of D11
  at its own pixel; its seed is that pixel plus a random +-20 px offset
  (the case the kernels line's ``ms`` reports, comparable across versions);
- ``collisions``: the same descriptors, seeds snapped to a 4x4 grid so 16
  queries share each seed;
- ``smooth_warp``: descriptors that vary smoothly over the image (a random
  field on an 8-pixel lattice, bilinearly upsampled, plus 10% noise), the
  true match of query (x, y) at round(a 1 degree rotation, a 1% scale and a
  (3, -2) px shift of (x, y) about the image centre), and seeds at the true
  match plus +-2 px noise: what the LM projection of a rigid scene hands the
  refine.

Ray-edge cases (``ray_case``; numpy-seeded, then moved to ``device``) at
N = 147,456 points (288x512), as ``slam/global_opt.py`` hands them to the
kernel: scal (E, 12), XiT (E, 3, N), w0 (E, N), the window's pointmaps
X (P, N, 3), jj (E,) int32, active (E,) bool. Two rows a keyframe pair, in
the window build's order (``slam/backend.py`` ``_build_window``):

- ``win16_4p``: P = 8, 4 consecutive pairs, 16 rows (8 live);
- ``win16_8p``: P = 16, 8 consecutive pairs, 16 rows (16 live);
- ``win32_11p``: P = 16, 10 consecutive pairs + the loop pair (0, 10), 32
  rows (22 live);
- ``all16``, ``all32``, ``all128``, ``all512``: every row live, jj = e mod
  16, P = 16; the last row's weights all 0.

Inactive rows hold stale nonzero data (another pose, points and weights, a
jj inside the window), as rows of an evicted pair would.

Calibrated edge cases (``calib_case``) at 384x512 (N = 196,608), as the
calibrated window solve hands them to its kernel: the window poses T (P, 8),
intr (4,), XiT (E, 3, N), w0 (E, N), X (P, N, 3), ii and jj (E,) int32, idx
(E, N) int32, active (E,) bool; the window buckets of a 32-frame session
(:data:`CALIB_CASES`: 16, 32 and 64 rows, a live prefix of consecutive
pairs, stale inactive rows). In every frame 2% of the points lie behind the
camera and 2% project off the pixel border; in every row 1% of frame i's
depths are 0 and 1% of the weights.

RoPE cases (``rope_case``): q and k as the qkv split's strided views or as
transposed projections, with tables of the tokens' grid (``rope_pos``).

Resample cases (``resample_frame``): (h, w, 3) f32 camera frames in [0, 1],
uint8 values over 255 as a camera's frames reach ``SLAM.grab_rgb``, of
:data:`RESAMPLE_SHAPES` (the downscales to the network's 512 side) and the
bicubic upscale and portrait frame the tests add: ``random`` (uniform
bytes), ``zeros``, ``ones`` and ``checker`` (a one-pixel checkerboard, the
filter's worst ringing and clipping).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from ..models import layers

REFINE_CASES = ("identity_pm20", "collisions", "smooth_warp")
RAY_N = 288 * 512
RAY_WINDOW_CASES = ("win16_4p", "win16_8p", "win32_11p")
RAY_ALL_ACTIVE_CASES = ("all16", "all32", "all128", "all512")
# calibrated window cases: (rows E, live rows A, window poses P) of a
# 32-frame session's power-of-two buckets, consecutive pairs, at 384x512
CALIB_CASES = {"win16": (16, 14, 8), "win32": (32, 30, 16), "win64": (64, 62, 32)}
CALIB_HW = (384, 512)
CALIB_K = (517.3, 516.5, 318.6, 255.3)  # TUM fr1 (fx, fy, cx, cy) of its 640x480 frames
# frames (h, w) the resample kernel shrinks to the 512 side: TUM's 640x480
# to 384x512, a 16:9 camera at 360p and at 720p to 288x512
RESAMPLE_SHAPES = ((480, 640), (360, 640), (720, 1280))
RESAMPLE_KINDS = ("random", "zeros", "ones", "checker")


def _grid(h: int, w: int, device) -> torch.Tensor:
    """(1, h*w, 2) [u, v] of the raster, row-major."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([xx, yy], -1).reshape(1, h * w, 2)


def _clip(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    lim = torch.tensor([w - 1, h - 1], device=p.device)
    return torch.minimum(p.clamp(min=0), lim)


def smooth_descriptors(h: int, w: int, g: torch.Generator, device, f: int = 24, cell: int = 8):
    """Unit descriptors that vary smoothly: a random field on a ``cell``-pixel
    lattice, bilinearly upsampled, plus 10% per-pixel noise."""
    gh, gw = h // cell + 3, w // cell + 3
    coarse = torch.randn((1, f, gh, gw), generator=g, device=device)
    up = F.interpolate(coarse, size=(gh * cell, gw * cell), mode="bilinear", align_corners=False)
    D = up[:, :, cell:cell + h, cell:cell + w].permute(0, 2, 3, 1)
    D = D + 0.1 * torch.randn((1, h, w, f), generator=g, device=device)
    return D / D.norm(dim=-1, keepdim=True)


def refine_case(kind: str, h: int, w: int, seed: int, device, f: int = 24):
    """(D11 (1, h, w, f), D21 (1, h*w, f), p1 (1, h*w, 2) int32) of one case."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = h * w
    grid = _grid(h, w, device)
    if kind in ("identity_pm20", "collisions"):
        D11 = torch.randn((1, h, w, f), generator=g, device=device)
        D11 = D11 / D11.norm(dim=-1, keepdim=True)
        D21 = D11.reshape(1, n, f) + 0.05 * torch.randn((1, n, f), generator=g, device=device)
        if kind == "collisions":
            p1 = torch.div(grid, 4, rounding_mode="floor") * 4
        else:
            p1 = grid + torch.randint(-20, 21, (1, n, 2), generator=g, device=device)
    elif kind == "smooth_warp":
        D11 = smooth_descriptors(h, w, g, device, f)
        th, s = math.radians(1.0), 1.01
        rot = s * torch.tensor([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]],
                               device=device)
        c = torch.tensor([w / 2, h / 2], device=device)
        shift = torch.tensor([3.0, -2.0], device=device)
        truth = _clip(torch.round((grid.float() - c) @ rot.T + c + shift).long(), h, w)
        lin = (truth[..., 1] * w + truth[..., 0])[..., None].expand(1, n, f)
        D21 = D11.reshape(1, n, f).gather(1, lin)
        D21 = D21 + 0.05 * torch.randn((1, n, f), generator=g, device=device)
        p1 = truth + torch.randint(-2, 3, (1, n, 2), generator=g, device=device)
    else:
        raise ValueError(f"unknown refine case {kind!r}")
    return D11, D21, _clip(p1, h, w).to(torch.int32)


def _ray_window(name: str):
    """(P, E, keyframe pairs) of a window case."""
    if name == "win16_4p":
        return 8, 16, [(k, k + 1) for k in range(4)]
    if name == "win16_8p":
        return 16, 16, [(k, k + 1) for k in range(8)]
    if name == "win32_11p":
        return 16, 32, [(k, k + 1) for k in range(10)] + [(0, 10)]
    raise ValueError(f"unknown ray case {name!r}")


def _sim3_scal(rng, E: int) -> np.ndarray:
    """(E, 12) [sR | t] of relative Sim(3)s near identity (Rodrigues)."""
    w = 0.05 * rng.standard_normal((E, 3))
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / np.maximum(th[:, :, 0], 1e-12)
    K = np.zeros((E, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    s = 1.0 + 0.01 * rng.standard_normal((E, 1, 1))
    t = 0.05 * rng.standard_normal((E, 3))
    return np.concatenate([(s * R).reshape(E, 9), t], axis=1)


def ray_case(name: str, seed: int, device, n_pts: int = RAY_N, dtype=torch.float32):
    """(scal, XiT, w0, X, jj, active) of one ray case (see the module
    docstring): pointmaps around z = 5, Xi = X[jj] + 0.05 noise, weights in
    [0, 2) with the first tenth of every row 0."""
    rng = np.random.default_rng(seed)
    if name.startswith("all"):
        E, P = int(name[3:]), 16
        jj = np.arange(E) % P
        active = np.ones(E, bool)
    else:
        P, E, pairs = _ray_window(name)
        jj = rng.integers(0, P, E)  # stale rows keep whatever they pointed at
        for k, (i, j) in enumerate(pairs):
            jj[2 * k], jj[2 * k + 1] = j, i
        active = np.arange(E) < 2 * len(pairs)
    X = rng.standard_normal((P, n_pts, 3), dtype=np.float32)
    X[..., 2] += 5.0
    XiT = np.ascontiguousarray(X[jj].transpose(0, 2, 1))
    XiT += 0.05 * rng.standard_normal(XiT.shape, dtype=np.float32)
    w0 = 2.0 * rng.random((E, n_pts), dtype=np.float32)
    w0[:, : n_pts // 10] = 0.0
    if name.startswith("all"):
        w0[-1] = 0.0  # a fully masked live row
    scal = _sim3_scal(rng, E)
    to = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    return (to(scal), to(XiT), to(w0), to(X), to(jj, torch.int32), to(active, torch.bool))


def calib_case(name: str, seed: int, device, hw=CALIB_HW, dtype=torch.float32):
    """(T, intr, XiT, w0, X, ii, jj, idx, active) of one calibrated case (see
    the module docstring): window poses near identity whose quaternions are
    off unit norm by ~1e-3 (as a keyframe chain's drift), each frame's
    pointmap backprojected from depths in [2, 6] through :data:`CALIB_K`
    scaled from 640x480 to ``hw``, matches at the own pixel +-3 px, z_i
    within 10% of frame j's depth, weights in [0, 2)."""
    E, A, P = CALIB_CASES[name]
    h, w = hw
    n = h * w
    rng = np.random.default_rng(seed)
    pairs = A // 2
    ii, jj = rng.integers(0, P, E), rng.integers(0, P, E)  # stale rows keep whatever they pointed at
    ii[0:A:2], jj[0:A:2] = np.arange(pairs), np.arange(1, pairs + 1)
    ii[1:A:2], jj[1:A:2] = np.arange(1, pairs + 1), np.arange(pairs)
    active = np.arange(E) < A
    q = np.concatenate([0.02 * rng.standard_normal((P, 3)), np.ones((P, 1))], 1)
    q *= ((1.0 + 1e-3 * rng.standard_normal((P, 1))) / np.linalg.norm(q, axis=1, keepdims=True))
    T = np.concatenate([0.05 * rng.standard_normal((P, 3)), q, 1.0 + 0.01 * rng.standard_normal((P, 1))], 1)
    fx, fy, cx, cy = CALIB_K[0] * w / 640, CALIB_K[1] * h / 480, CALIB_K[2] * w / 640, CALIB_K[3] * h / 480
    k = np.arange(n)
    u, v = k % w, k // w
    z = rng.uniform(2.0, 6.0, (P, n))
    X = np.stack([z * (u - cx) / fx, z * (v - cy) / fy, z], -1)
    X[:, n // 20: n // 20 + n // 50, 2] *= -1.0  # behind the camera
    X[:, n // 10: n // 10 + n // 50, 0] *= 3.0  # projected off the pixel border
    XiT = X[jj].transpose(0, 2, 1).copy()
    XiT[:, 2] *= rng.uniform(0.9, 1.1, (E, n))
    XiT[:, 2, n // 5: n // 5 + n // 100] = 0.0  # frame i's depth under depth_eps
    du, dv = rng.integers(-3, 4, (E, n)), rng.integers(-3, 4, (E, n))
    idx = np.clip(v + dv, 0, h - 1) * w + np.clip(u + du, 0, w - 1)
    w0 = 2.0 * rng.random((E, n))
    w0[:, : n // 100] = 0.0
    to = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    return (to(T), to(np.array([fx, fy, cx, cy])), to(XiT), to(w0), to(X), to(ii, torch.int32),
            to(jj, torch.int32), to(idx, torch.int32), to(active, torch.bool))


def ray_counts(jj: torch.Tensor, active: torch.Tensor):
    """(A, D): live rows and the distinct frames they read."""
    return int(active.sum()), int(torch.unique(jj[active]).numel())


def attention_case(B: int, H: int, Nq: int, Nk: int, D: int, dtype, seed: int, device):
    """q (scaled by 2, so the softmax is peaked), k, v as (B, H, N, D)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = (2.0 * torch.randn((B, H, Nq, D), generator=g, device=device)).to(dtype)
    k = torch.randn((B, H, Nk, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, H, Nk, D), generator=g, device=device).to(dtype)
    return q, k, v


# the token grids of the model's token counts: 512x384 and 288x512 frames
ROPE_GRIDS = {768: (24, 32), 576: (18, 32)}


def rope_pos(B: int, N: int, device) -> torch.Tensor:
    """(B, N, 2) int32 (y, x) positions in raster order on the
    :data:`ROPE_GRIDS` grid of ``N`` tokens, else on one row."""
    gh, gw = ROPE_GRIDS.get(N, (1, N))
    yy, xx = torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device), indexing="ij")
    return torch.stack([yy, xx], -1).reshape(1, N, 2).expand(B, N, 2).to(torch.int32)


def rope_case(B: int, H: int, Nq: int, Nk: int, D: int, dtype, layout: str, seed: int, device, base=100.0):
    """q, k and their RoPE tables as the model hands them to ``rope2d_``.
    ``layout="qkv"``: q and k are the strided views of one (B, Nq, 3, H, D)
    projection (self-attention: ``Nk`` is ignored, one table for both);
    ``"proj"``: (B, N, H, D) projections transposed (cross-attention, a
    table each). Values scaled by 2, as the attention case's q."""
    g = torch.Generator(device=device).manual_seed(seed)
    tq = layers.rope_tables(rope_pos(B, Nq, device), D, base, dtype)
    if layout == "qkv":
        qkv = (2.0 * torch.randn((B, Nq, 3, H, D), generator=g, device=device)).to(dtype)
        return qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2), tq, tq
    q = (2.0 * torch.randn((B, Nq, H, D), generator=g, device=device)).to(dtype).transpose(1, 2)
    k = (2.0 * torch.randn((B, Nk, H, D), generator=g, device=device)).to(dtype).transpose(1, 2)
    return q, k, tq, layers.rope_tables(rope_pos(B, Nk, device), D, base, dtype)


def cuda_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_queued(fn, reps=50, warmup=3):
    """Device ms per call of ``fn()``: ``reps`` calls queued behind a spin
    kernel, so the events bracket back-to-back device work and not the
    host's submission rate (for kernels shorter than their launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))  # ~0.1 s: the host queues every call meanwhile
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def resample_frame(h: int, w: int, kind: str, seed: int, device) -> torch.Tensor:
    """(h, w, 3) f32 frame of one :data:`RESAMPLE_KINDS` kind: uint8 values
    over 255 (``np.float32`` division, as a loader makes them)."""
    if kind == "random":
        u = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind in ("zeros", "ones"):
        u = np.full((h, w, 3), 0 if kind == "zeros" else 255, np.uint8)
    elif kind == "checker":
        yy, xx = np.indices((h, w))
        u = np.repeat((255 * ((yy + xx) % 2)).astype(np.uint8)[..., None], 3, -1)
    else:
        raise ValueError(f"unknown resample case {kind!r}")
    return torch.from_numpy(u.astype(np.float32) / 255.0).to(device)
