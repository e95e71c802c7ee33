"""The coarse-to-fine descriptor refine: Hopper kernel, plain version, counter.

What it computes (reference ``matching_kernels.cu:25-125``; the JAX package's
``refine_matches_gather``): for each query descriptor D21[b, k] and integer
start pixel p1[b, k], levels d = dilation_max .. 1 each probe a (2r+1)^2
window at stride d around the running best, u-major; off-image probes are
masked; a probe must be strictly greater to win; each level recentres at the
best. Returns ``p1_new`` (b, n, 2) int32 and ``max_scores`` (b, n) f32.

Which TPU kernels it replaces: ``frodo_slam_tpu/ops/refine_fused_pallas.py``
``_corr_mark_kernel`` (pallas_call at :303) and ``_relocate_kernel`` (:322),
driven by ``refine_matches_fused``. The TPU needed the scatter-into-a-plane,
shifted-dot and pull-relocation form only because Mosaic lowers neither a
value scatter nor a per-lane gather; its collision truncation (a query that
loses a contested pixel stops refining) is a layout artifact that this
kernel does not reproduce. Here the two become ONE per-query search
(``csrc/refine_matches.cu``): a CTA of 384 threads takes a 2-D tile of the
query raster (32 x 12; 384 consecutive queries when n != h * w, see
:func:`refine_tile_plan`), one thread per query with its row in 24 f32
registers; neighbouring queries probe overlapping windows, which L1 then
serves.

What bounds it: at 384x512 a cold refine does 5 levels x 49 probes x 24
f32 FMAs per query, 2.3 GFLOP (0.035 ms at 67 TFLOP/s: the dot stays a
sequential f32 fmaf, so the tensor cores cannot take it), against ~38 MB of
f32 inputs and outputs (0.012 ms at 3.35 TB/s). Its probes read 2.3 GB of
48-byte rows, which queries taken in raster order, one probe's loads in
flight at a time, would fetch from L2; 2-D tiles let L1 serve most of
them.

Dispatch: a CPU tensor runs :func:`refine_matches_plain` (bf16); a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernel_build

_SRC = kernel_build.CSRC / "refine_matches.cu"
NVCC_FLAGS = kernel_build.NVCC_FLAGS


def refine_matches_plain(D11: torch.Tensor, D21: torch.Tensor, p1: torch.Tensor,
                         radius: int = 3, dilation_max: int = 5,
                         dtype: torch.dtype = torch.bfloat16, count_probes: bool = False):
    """Plain PyTorch refine on any device.

    ``dtype`` is the descriptor type the dots see: bf16 rounds D11/D21 to
    bf16 first (the kernel's contract), f32 keeps them (the JAX package's
    ``refine_matches_gather``). Either way the dot is a sequential f32 sum
    over the descriptor channels, in channel order, like the kernel.

    D11: (b, h, w, f); D21: (b, n, f); p1: (b, n, 2) int pixel guesses.
    ``count_probes`` also returns the number of in-image probes (the dots
    this input needs), as a 0-d int64 tensor.
    """
    b, h, w, f = D11.shape
    n = D21.shape[1]
    flat = D11.to(dtype).float().reshape(b, h * w, f)
    Q = D21.to(dtype).float()
    u0 = p1[..., 0].long()
    v0 = p1[..., 1].long()
    neg_inf = torch.full((b, n), float("-inf"), dtype=torch.float32, device=D11.device)
    max_score = neg_inf
    u_best, v_best = u0, v0
    n_side = 2 * radius + 1
    probes = torch.zeros((), dtype=torch.int64, device=D11.device)
    for d in range(dilation_max, 0, -1):
        rd = radius * d
        for i in range(n_side):
            u = u0 - rd + i * d
            for j in range(n_side):
                v = v0 - rd + j * d
                inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
                if count_probes:
                    probes = probes + inside.sum()
                lin = v.clamp(0, h - 1) * w + u.clamp(0, w - 1)
                desc = torch.gather(flat, 1, lin[..., None].expand(b, n, f))
                score = torch.zeros_like(max_score)  # fmaf(q, d, +0) in the kernel
                for k in range(f):
                    score = score + desc[..., k] * Q[..., k]
                score = torch.where(inside, score, neg_inf)
                better = score > max_score
                u_best = torch.where(better, u, u_best)
                v_best = torch.where(better, v, v_best)
                max_score = torch.where(better, score, max_score)
        u0, v0 = u_best, v_best
    p_new = torch.stack([u_best, v_best], dim=-1).to(torch.int32)
    return (p_new, max_score, probes) if count_probes else (p_new, max_score)


TILE_THREADS = 384  # queries per CTA
MAX_RADIUS = 3  # the kernel's radius is a template parameter: 0..3


def refine_tile_plan(h: int, w: int, n: int) -> dict:
    """The kernel's query tiling. When n == h * w the queries are D11's
    raster (``ops/matching.py``): the query grid is w wide and a CTA takes a
    32 x 12 tile of it. Otherwise a CTA takes 384 consecutive queries (a
    1-D tile). Returns the grid width ``gw``, tile width and height and the
    CTA grid (x, y) per batch element."""
    if n == h * w:
        gw, tile_w = w, 32
    else:
        gw, tile_w = max(n, 1), TILE_THREADS
    tile_h = TILE_THREADS // tile_w
    gh = -(-n // gw)
    return dict(gw=gw, tile_w=tile_w, tile_h=tile_h,
                grid=(-(-gw // tile_w), -(-gh // tile_h)))


def library_path():
    return kernel_build.library_path(_SRC)


def build():
    """Compile the kernel into ``build/kernels/`` (see :mod:`.kernel_build`)."""
    return kernel_build.build(_SRC)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    fn = lib.refine_matches_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _aligned_bf16(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.bfloat16).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def refine_matches(D11: torch.Tensor, D21: torch.Tensor, p1: torch.Tensor,
                   radius: int = 3, dilation_max: int = 5):
    """Refine on the card (CUDA tensors) or with the bf16 plain version (CPU
    tensors). D11: (b, h, w, 24); D21: (b, n, 24); p1: (b, n, 2) int;
    radius 0..3 on the card. Returns (p1_new (b, n, 2) int32, max_scores
    (b, n) f32)."""
    if D11.device.type == "cpu":
        return refine_matches_plain(D11, D21, p1, radius, dilation_max, torch.bfloat16)
    if D11.device.type != "cuda":
        raise RuntimeError(f"refine_matches: no kernel for device {D11.device}")
    b, h, w, f = D11.shape
    if f != 24:
        raise ValueError(f"refine_matches: the kernel takes 24-wide descriptors, got {f}")
    if D21.dim() != 3 or D21.shape[0] != b or D21.shape[2] != f:
        raise ValueError(f"refine_matches: D21 {tuple(D21.shape)} does not fit D11 {tuple(D11.shape)}")
    n = D21.shape[1]
    if tuple(p1.shape) != (b, n, 2):
        raise ValueError(f"refine_matches: p1 {tuple(p1.shape)} != {(b, n, 2)}")
    if not (D21.device == p1.device == D11.device):
        raise ValueError("refine_matches: inputs on different devices")
    if not 0 <= radius <= MAX_RADIUS or dilation_max < 0:
        raise ValueError(f"refine_matches: radius must be 0..{MAX_RADIUS} and dilation_max >= 0")
    if 3 * h * w >= 2 ** 31:
        raise ValueError(f"refine_matches: a {h}x{w} image is too large for the kernel's offsets")
    d11 = _aligned_bf16(D11)
    d21 = _aligned_bf16(D21)
    pin = p1.to(torch.int32).contiguous()
    p_out = torch.empty((b, n, 2), dtype=torch.int32, device=D11.device)
    scores = torch.empty((b, n), dtype=torch.float32, device=D11.device)
    plan = refine_tile_plan(h, w, n)
    lib = _library()
    with torch.cuda.device(D11.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refine_matches_launch(
            d11.data_ptr(), d21.data_ptr(), pin.data_ptr(), p_out.data_ptr(),
            scores.data_ptr(), b, h, w, n,
            plan["gw"], plan["tile_w"], radius, dilation_max, stream)
    if err != 0:
        raise RuntimeError(f"refine_matches kernel launch failed: error {err}")
    refine_matches.launches += 1
    return p_out, scores


refine_matches.launches = 0
