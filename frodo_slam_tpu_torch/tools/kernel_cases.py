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
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

REFINE_CASES = ("identity_pm20", "collisions", "smooth_warp")


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
