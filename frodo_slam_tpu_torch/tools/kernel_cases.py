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
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

REFINE_CASES = ("identity_pm20", "collisions", "smooth_warp")
RAY_N = 288 * 512
RAY_WINDOW_CASES = ("win16_4p", "win16_8p", "win32_11p")
RAY_ALL_ACTIVE_CASES = ("all16", "all32", "all128", "all512")


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
