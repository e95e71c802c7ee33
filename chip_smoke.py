#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (one JSON line each; any failure exits nonzero, nothing is caught):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: every hand-written kernel compiled from csrc/ with nvcc, one
     nvcc per source, and the host popcount kernels with g++, all started
     together;
  3. refine: the Hopper refine kernel vs its bf16 plain version at the
     dataset path's shape (1, 384, 512, 24) and at (1, 288, 512, 24),
     radius 3, dilation 5, on the three cases of tools/kernel_cases.py
     (+-20 px seeds, colliding seeds, a smooth warp); bitwise equal; kernel
     ms per case; the plain version's ms (CUDA events, median of 20); the
     bound (bytes / 3.35 TB/s vs operations / peak) and the f32 FMA floor;
  4. attention: the Hopper flash-attention kernel vs its plain version at
     the model's shapes (bf16, head dim 64: the encoder at 768 and 576
     tokens, the batched decoders, the backend's pair batch, ragged N and
     Nq != Nk) and in f32 at head dims 32 and 24; within the stated bar;
     kernel, plain and library (scaled_dot_product_attention, timed only)
     device ms per call beside the bound;
  5. tiny: track_step at tiny_config on the card vs the same on the CPU
     (plain versions), same weights and inputs;
  6. main: the ViT-L frontend (MASt3RConfig() widths, bf16 transformer, f32
     heads, random weights from a seeded generator) through SLAM.grab_rgb on
     12 synthetic 288x512 frames, backend and relocalization off; per-frame
     ms, peak memory, outcome counts;
  7. ray_reduce: the Hopper ray-edge kernel vs its plain version at
     N = 147,456 points per edge on the window cases of tools/kernel_cases.py
     (16 rows with 8 or 16 live, 32 with 22; stale inactive rows) and the
     all-active E in {16, 32, 128, 512} (jj = e mod 16), plus two N off the
     tile: f32 kernel vs f64 plain within 1e-4 of each live edge's largest
     entry, f64 kernel within 1e-10; inactive rows exactly 0; two calls
     bitwise equal; device ms (queued calls) and single-call ms, f64 device
     ms and plain ms beside the bound of the work the inputs need (A live
     rows, D distinct frames);
  8. backend_tiny: SLAM(use_backend=True) with odometry at tiny_config on
     the card vs the same on the CPU: flags equal, keyframe poses atol 1e-4;
  9. calib_tiny: the same with a calibration (calibrated tracker and window
     solve): flags equal, keyframe poses atol 1e-4, no ray-kernel launch;
 10. backend_main: ViT-L 288x512 with shared heads and decoders (so that
     identical frames track), 12 identical frames, every frame a keyframe,
     production capacities, an odometry pose per frame, once serialized and
     once threaded; then one add_factors of two pairs (one a loop closure)
     and a window solve. Per-frame ms, per-task decode+match and solve ms
     (serialized run only: its stages are timed between syncs), GN
     iterations and ray-kernel launches per solve, edges, peak memory; any
     backend task that failed (the worker logs it) fails the phase;
 11. dataset_main: the dataset runner, ``frodo_slam_tpu_torch.main.run``,
     on a TUM fr1 sequence that this script writes (24 identical 640x480
     PNGs under build/chip_smoke/), with a config that inherits
     configs/eval_calib.yaml (calibrated tracker and backend, subsample 2,
     serialized) and forces every tracked frame to a keyframe, ViT-L at
     512x384 with shared random decoders, --no-retrieval --save-as: finite
     trajectory rows, the .ply, one PNG per keyframe; per-frame and
     per-solve ms, edge rows per window, peak memory;
 12. reloc_main: retrieval loop closure and relocalization through threaded
     SLAM(use_backend=True, use_reloc=True) at ViT-L 288x512 (shared random
     decoders), the retrieval head at 1024 -> 1024 with nfeat 300 and a
     random codebook of 65,536 words (256 MiB on the card): a camera panning
     over a smooth random panorama, every frame a keyframe (the fnn fallback
     accepts a pan of a few steps), back over part of the way (a revisited
     image must be retrieved and become a loop-closure edge), two blank
     frames (lost; their relocalizations fail), then the map's first
     image, too far from the active keyframe to track: it must relocalize
     before the map resets. First the host popcount kernels
     against their numpy plain versions at the query's shapes. Per-keyframe
     retrieval ms split into query and insert, relocalization ms, loop
     edges, launches;
 13. synthetic: the port's oracle harness (``python -m
     frodo_slam_tpu_torch.tools.eval_synthetic --device cuda``) in
     subprocesses: the straight row (10 frames at 3 mm), the --per-frame row
     (warm frames) and the loop row (14 frames at 4 mm, with and without
     retrieval), each held to the JAX package's bars; ATEs and launches;
 14. the script's wall time; the kernels line; the device line (last line
     of stdout).

On every path (6, 10, 11, 12 and 13) the kernel launch counters are zeroed
just before it and read just after; each path must launch each of its
kernels (the oracle of 13 replaces the model: no attention there).
Its peak memory window starts after a garbage collection, and the bytes
still allocated then are printed beside the peak.

Without a card, or without the rest of the repository beside it, it exits
nonzero before printing any result.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import pathlib
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(2)

from frodo_slam_tpu_torch import main as runner  # noqa: E402
from frodo_slam_tpu_torch.config import make_config  # noqa: E402
from frodo_slam_tpu_torch.data.synthetic import smooth_random_frames  # noqa: E402
from frodo_slam_tpu_torch.models import mast3r  # noqa: E402
from frodo_slam_tpu_torch.ops import attention_kernel, ba_reduce_kernel, refine_kernel  # noqa: E402
from frodo_slam_tpu_torch.ops import lie  # noqa: E402
from frodo_slam_tpu_torch.slam import frame as frame_mod  # noqa: E402
from frodo_slam_tpu_torch.slam.backend import BackendGraph  # noqa: E402
from frodo_slam_tpu_torch.slam import tracker  # noqa: E402
from frodo_slam_tpu_torch.slam.inference import decode_mono  # noqa: E402
from frodo_slam_tpu_torch.slam.system import SLAM  # noqa: E402
from frodo_slam_tpu_torch.tools import kernel_cases  # noqa: E402
from frodo_slam_tpu_torch.tools.kernel_cases import cuda_ms, cuda_ms_queued  # noqa: E402
from frodo_slam_tpu_torch.retrieval import asmk  # noqa: E402
from frodo_slam_tpu_torch.retrieval.database import RetrievalDatabase  # noqa: E402
from frodo_slam_tpu_torch.retrieval.model import RetrievalHead  # noqa: E402
from frodo_slam_tpu_torch.utils import native  # noqa: E402
from frodo_slam_tpu_torch.utils.device import set_f32_contract  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
F64_OPS_PER_S = 34e12  # f64 outside the tensor cores
KERNELS = [refine_kernel, ba_reduce_kernel, attention_kernel]  # every hand-written kernel module
# each kernel's counted wrapper: it adds one where it launches its kernel
WRAPPERS = {"refine_matches": refine_kernel.refine_matches,
            "ray_edge_systems": ba_reduce_kernel.ray_edge_systems,
            "flash_attention": attention_kernel.flash_attention}
DEV = torch.device("cuda:0")
ROOT = pathlib.Path(__file__).resolve().parent


def zero_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_peak() -> int:
    """Start a path's peak-memory window: collect what earlier phases left
    in reference cycles (their SLAM objects), so that the peak is the
    path's own, and return the bytes still allocated at its start."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def emit(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    """One nvcc per kernel source and g++ for the host kernels, all started
    together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        results = list(pool.map(lambda mod: mod.build(), KERNELS + [native]))
    emit("host_build", library=native.library_path().name, seconds=round(results[-1][0], 3))
    for mod, (seconds, log) in zip(KERNELS, results):
        lines = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        emit("ptxas", kernel=mod.__name__, seconds=round(seconds, 3), log=lines)
        # a nonzero stack frame: per-thread arrays or spills in local memory
        if any("stack frame" in ln and not ln.strip().startswith("0 bytes") for ln in lines):
            raise AssertionError(f"{mod.__name__}: a kernel uses local memory: {lines}")
    emit("build", seconds=round(time.perf_counter() - t0, 3))


# the dataset path's grid (512x384 frames) first, then the 288x512 paths
REFINE_SHAPES = [(384, 512), (288, 512)]


def _refine_at(h, w, radius=3, dmax=5):
    """Every case of ``tools/kernel_cases.py`` at one grid: bitwise equal to
    the bf16 plain version and kernel ms; the plain version's ms and the
    bound on identity_pm20."""
    max_err = 0.0
    per_case = {}
    for seed, name in enumerate(kernel_cases.REFINE_CASES):
        D11, D21, p1 = kernel_cases.refine_case(name, h, w, seed, DEV)
        pk, sk = refine_kernel.refine_matches(D11, D21, p1, radius, dmax)
        torch.cuda.synchronize()
        pp, sp, nprobe = refine_kernel.refine_matches_plain(D11, D21, p1, radius, dmax,
                                                             count_probes=True)
        equal = bool(torch.equal(pk, pp)) and bool(torch.equal(sk, sp))
        err = float((sk - sp).abs().max())
        uniq = int(torch.unique(p1[0, :, 0] + D11.shape[2] * p1[0, :, 1]).numel())
        r = dict(shape=[h, w], case=name, equal=equal, max_abs_err=err, unique_seeds=uniq,
                 moved=float((pk != p1).any(-1).float().mean()), probes=int(nprobe),
                 ms=cuda_ms(lambda: refine_kernel.refine_matches(D11, D21, p1, radius, dmax)))
        emit("refine_check", **r)
        if not equal:
            raise AssertionError(f"refine kernel != plain on {name} at {h}x{w}")
        max_err = max(max_err, err)
        per_case[name] = r
    D11, D21, p1 = kernel_cases.refine_case("identity_pm20", h, w, 0, DEV)
    plain_ms = cuda_ms(lambda: refine_kernel.refine_matches_plain(D11, D21, p1, radius, dmax))
    n = p1.shape[1]
    probes = per_case["identity_pm20"]["probes"]
    # each f32 input read once, each output written once
    nbytes = D11.numel() * 4 + D21.numel() * 4 + p1.numel() * 4 + n * 2 * 4 + n * 4
    # the dots this input needs: 2 ops per channel per in-image probe, over
    # bf16 values (the kernel's contract), at the bf16 peak; the dot must stay
    # a sequential f32 fmaf to be bitwise, so its floor on FMA is also given
    ops = 2 * D11.shape[-1] * probes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    out = dict(shape=[h, w], ms=per_case["identity_pm20"]["ms"], ms_smooth=per_case["smooth_warp"]["ms"],
               ms_collisions=per_case["collisions"]["ms"],
               plain_ms=plain_ms, bytes=nbytes, ops=ops, probes=probes,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               fma_floor_ms=ops / F32_OPS_PER_S * 1e3,
               fma_floor_ms_smooth=2 * D11.shape[-1] * per_case["smooth_warp"]["probes"] / F32_OPS_PER_S * 1e3,
               max_abs_err=max_err)
    emit("refine_time", **out)
    return out


def phase_refine():
    return {f"{h}x{w}": _refine_at(h, w) for h, w in REFINE_SHAPES}


# ---------------------------------------------------------------------------
# attention: the flash-attention kernel vs its plain version
# ---------------------------------------------------------------------------

# (B, H, Nq, Nk, D, dtype): the encoder at 512x384 and 288x512, the two
# decoders batched, a ragged N, the backend's pair batch; f32 at head dims
# 32 and 24; the B = 1 decoder passes at 288x512 and 512x384
ATTN_SHAPES = [(1, 16, 768, 768, 64, torch.bfloat16), (2, 12, 768, 768, 64, torch.bfloat16),
               (1, 16, 576, 576, 64, torch.bfloat16), (1, 16, 700, 700, 64, torch.bfloat16),
               (4, 12, 768, 768, 64, torch.bfloat16), (1, 12, 768, 640, 64, torch.bfloat16),
               (2, 2, 96, 96, 32, torch.float32), (1, 2, 100, 77, 24, torch.float32),
               (1, 12, 576, 576, 64, torch.bfloat16), (1, 12, 768, 768, 64, torch.bfloat16)]
def attention_bound(B, H, Nq, Nk, D, dtype):
    """Least time for one call: 4 B H Nq Nk D operations (two products) at
    the type's peak vs q, k, v read once and o written once over the memory
    rate. Returns (ms, "operations" or "bytes")."""
    esize = torch.tensor([], dtype=dtype).element_size()
    t_bytes = esize * B * H * (2 * Nq + 2 * Nk) * D / HBM_BYTES_PER_S * 1e3
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_ops = 4.0 * B * H * Nq * Nk * D / peak * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# bf16: p and the output are rounded to bf16 at different places than in the
# plain version (running vs final max; each rounding <= 2^-9 relative), so
# the bar is 1e-2 of the output's largest magnitude; f32: summation order only
ATTN_BAR = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def phase_attention():
    fa = attention_kernel.flash_attention
    out = []
    for i, (B, H, Nq, Nk, D, dt) in enumerate(ATTN_SHAPES):
        q, k, v = kernel_cases.attention_case(B, H, Nq, Nk, D, dt, 100 + i, DEV)
        before = fa.launches
        ok = fa(q, k, v)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        op = attention_kernel.flash_attention_plain(q, k, v)
        scale = float(op.float().abs().max())
        err = float((ok.float() - op.float()).abs().max())
        bound_ms, bound_by = attention_bound(B, H, Nq, Nk, D, dt)
        r = dict(shape=[B, H, Nq, Nk, D], dtype=str(dt).split(".")[-1], max_abs_err=err,
                 out_max_abs=scale, bar=ATTN_BAR[dt] * max(scale, 1.0),
                 ms=cuda_ms_queued(lambda: fa(q, k, v)),
                 plain_ms=cuda_ms_queued(lambda: attention_kernel.flash_attention_plain(q, k, v), reps=10),
                 library_ms=cuda_ms_queued(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
                 bound_ms=bound_ms, bound_by=bound_by)
        emit("attention", **r)
        out.append(r)
        if not err <= r["bar"]:
            raise AssertionError(f"attention kernel disagrees with its plain version at {r['shape']}")
        del q, k, v, ok, op
    torch.cuda.empty_cache()
    return out


def _tiny_model(device):
    cfg = mast3r.tiny_config()
    model = mast3r.init_model(cfg, seed=0, device="cpu")
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    return model.to(device)


def _tiny_track(device):
    """Init a keyframe from one image, then track the same image (cold)."""
    model = _tiny_model(device)
    h, w = 32, 64
    img = torch.from_numpy(np.random.default_rng(1).normal(size=(1, h, w, 3)).astype(np.float32)).to(device)
    feat, pos = mast3r.encode_image(model, img)
    X, C = decode_mono(model, feat, pos, (h, w))
    kf = frame_mod.make_empty_frame(0, img, feat, pos)
    Xn, Cn, Nn, Un = frame_mod.update_pointmap(kf.X_canon, kf.C, kf.N, kf.N_updates, X, C)
    kf = frame_mod.Frame(**{**kf.__dict__, "X_canon": Xn, "C": Cn, "N": Nn, "N_updates": Un})
    fr = frame_mod.make_empty_frame(1, img, feat, pos)
    cfg = tracker.TrackingCfg(max_iters=10, Q_conf=0.0, match_frac_thresh=1.1, use_fnn=True)
    match_cfg = tuple(sorted(dict(make_config().matching).items()))
    _, _, res = tracker.track_step(model, cfg, match_cfg, (h, w), kf, fr, None)
    return res.flags.cpu().numpy(), res.idx_f2k.cpu().numpy()


def phase_tiny():
    before = read_counts()
    fl_g, idx_g = _tiny_track(DEV)
    launched = {k: v - before[k] for k, v in read_counts().items()}
    fl_c, idx_c = _tiny_track(torch.device("cpu"))
    agree = float((idx_g == idx_c).mean())
    emit("tiny", flags_cuda=[float(x) for x in fl_g[[0, 1, 2, 19]]],
         flags_cpu=[float(x) for x in fl_c[[0, 1, 2, 19]]],
         pose_max_abs_diff=float(np.abs(fl_g[3:19] - fl_c[3:19]).max()), idx_agree=agree,
         kernel_launches=launched)
    assert np.isfinite(fl_g).all()
    assert launched["refine_matches"] > 0 and launched["flash_attention"] > 0, launched
    assert (fl_g[[1, 2, 19]] == fl_c[[1, 2, 19]]).all() and fl_g[1] == 1.0
    assert abs(fl_g[0] - fl_c[0]) < 0.02 and agree > 0.97
    np.testing.assert_allclose(fl_g[3:19], fl_c[3:19], atol=1e-4)


def phase_main(n_frames=12):
    h, w = 288, 512
    cfg = mast3r.MASt3RConfig()
    t0 = time.perf_counter()
    model = mast3r.init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    slam = SLAM(make_config(), model, (h, w), use_backend=False)
    frames = smooth_random_frames(n_frames, h, w)
    at_start = reset_peak()
    counts = dict(ok=0, new_kf=0, fnn=0, reset=0)
    ms = []
    poses = []
    zero_counts()
    for i, img in enumerate(frames):
        n_atlas = len(slam.atlas)
        last = slam.last_track
        t = time.perf_counter()
        ok, T, new_kf = slam.grab_rgb(img, timestamp=float(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        poses.append(np.asarray(T))
        counts["ok"] += int(ok)
        counts["new_kf"] += int(new_kf)
        counts["reset"] += int(len(slam.atlas) > n_atlas)
        if slam.last_track is not last:  # this frame was tracked
            counts["fnn"] += int(slam.last_track.flags[19].item() > 0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    emit("main", frames=n_frames, model_init_s=round(init_s, 3), frame_ms=[round(x, 3) for x in ms],
         mean_ms_after_first=statistics.mean(ms[1:]), median_ms_after_first=statistics.median(ms[1:]),
         max_memory_allocated=peak, allocated_at_start=at_start, counts=counts, launches=launches,
         store_n_total=slam.store.n_total, atlas=len(slam.atlas))
    assert all(p.shape == (8,) and np.isfinite(p).all() for p in poses)
    assert launches["refine_matches"] > 0, "the main path never launched the refine kernel"
    assert launches["flash_attention"] > 0, "the main path never launched the attention kernel"
    slam.terminate()
    return launches, ms


# ---------------------------------------------------------------------------
# backend: the ray-edge kernel and SLAM(use_backend=True)
# ---------------------------------------------------------------------------

RAY_KW = dict(sigma_ray=0.003, sigma_dist=10.0)
# the window cases of tools/kernel_cases.py (the shapes backend_main's
# solves make), the all-active cases, and two N off the 512-point tile: one
# a multiple of 4 points (bulk copies, a ragged last tile), one not (rows
# not 16-byte aligned: the ring filled by the producer's own loads)
RAY_CASES = ([(c, kernel_cases.RAY_N) for c in kernel_cases.RAY_WINDOW_CASES + kernel_cases.RAY_ALL_ACTIVE_CASES]
             + [("win16_4p", kernel_cases.RAY_N - 332), ("all16", kernel_cases.RAY_N - 333)])


def _rel_err(got, want, live):
    """Largest per-edge |got - want| over that edge's largest |entry|, over
    the live edges."""
    E = want.shape[0]
    scale = want.reshape(E, -1).abs().amax(1).clamp(min=1e-300)
    return float(((got.double() - want).reshape(E, -1).abs().amax(1) / scale)[live].max())


def ray_bound(A, D, E, N, itemsize=4):
    """Least time for one call, for the work these inputs need: each live
    row's Xi and w0 read once (4 scalars a point), each distinct frame its
    live rows read once (3), the 12 scalars of every row, B and g written
    (56), vs A x N x FLOPS_PER_POINT operations at the f32 (or f64) peak
    outside the tensor cores. ``all_rows_bound_ms``: the two-pass kernel's
    form, every row streamed with its own Xj, E x N x 7 scalars."""
    nbytes = itemsize * (A * N * 4 + D * N * 3 + E * 12 + E * 56)
    ops = A * N * ba_reduce_kernel.FLOPS_PER_POINT
    peak = F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    old = itemsize * (E * N * 7 + E * 12 + E * 56) / HBM_BYTES_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", all_rows_bound_ms=old)


def phase_ray_reduce():
    """Every case of RAY_CASES: f32 and f64 kernel vs the f64 plain version,
    inactive rows exactly 0, two calls bitwise equal; at N = 147,456 the
    device time (calls queued behind a spin kernel), the single-call time
    (events around one call: what the eager solve pays), the f64 device
    time, the plain version's time and the bound."""
    rk = ba_reduce_kernel
    per_case = {}
    for k, (case, n) in enumerate(RAY_CASES):
        args = kernel_cases.ray_case(case, k, DEV, n_pts=n)
        jj, active = args[4], args[5]
        A, D = kernel_cases.ray_counts(jj, active)
        E = int(jj.shape[0])
        run32 = lambda: rk.ray_edge_systems(*args, **RAY_KW, n_active=A)  # noqa: E731
        d64 = tuple(a.double() for a in args[:4]) + (jj, active)
        run64 = lambda: rk.ray_edge_systems(*d64, **RAY_KW, n_active=A)  # noqa: E731
        (B32, g32), (B32b, g32b), (B64, g64), (B64b, g64b) = run32(), run32(), run64(), run64()
        torch.cuda.synchronize()
        Bp, gp = rk.ray_edge_systems_plain(*d64, **RAY_KW)
        live = active.cpu()
        dead = ~active
        out = dict(case=case, E=E, N=n, A=A, D=D,
                   err_f32=max(_rel_err(B32, Bp, live), _rel_err(g32, gp, live)),
                   err_f64=max(_rel_err(B64, Bp, live), _rel_err(g64, gp, live)),
                   max_abs_err_f32=float(max((B32.double() - Bp).abs().max(),
                                             (g32.double() - gp).abs().max())),
                   repeatable=bool(torch.equal(B32, B32b) and torch.equal(g32, g32b)
                                   and torch.equal(B64, B64b) and torch.equal(g64, g64b)),
                   inactive_zero=bool(all(int(torch.count_nonzero(t[dead])) == 0
                                          for t in (B32, g32, B64, g64))))
        del Bp, gp
        if n == kernel_cases.RAY_N:
            out["device_ms"] = cuda_ms_queued(run32)
            out["single_ms"] = cuda_ms(run32)
            out["f64_device_ms"] = cuda_ms_queued(run64)
            out["plain_ms"] = cuda_ms(lambda: rk.ray_edge_systems_plain(*args, **RAY_KW), reps=3, warmup=1)
            out["f64_bound_ms"] = ray_bound(A, D, E, n, 8)["bound_ms"]
            out.update(ray_bound(A, D, E, n))
            per_case[case] = out
        emit("ray_reduce", **out)
        if not (out["err_f32"] <= 1e-4 and out["err_f64"] <= 1e-10):
            raise AssertionError(f"ray kernel disagrees with its plain version on {case}, N={n}")
        if not (out["repeatable"] and out["inactive_zero"]):
            raise AssertionError(f"ray kernel not repeatable or an inactive row not 0 on {case}, N={n}")
        del args, d64, B32, g32, B32b, g32b, B64, g64, B64b, g64b
        torch.cuda.empty_cache()
    return per_case


class _Failures(logging.Handler):
    """Collects ERROR records (a failed backend task is logged by the worker
    and swallowed there, so the log is where a failure shows)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


# tests/test_system.py's success-path thresholds: every frame tracks and
# becomes a keyframe; local_opt.max_iters stays 10
FORCE_KEYFRAMES = dict(
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.0})


def _backend_cfg(use_calib=False, **tpu):
    return make_config(**FORCE_KEYFRAMES, use_calib=use_calib, tpu=tpu)


def _odom(i):
    return np.array([0.05 * i, 0.01 * i, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32)


def _tiny_backend(device):
    model = _tiny_model(device)
    h, w = 32, 64
    img = np.random.default_rng(2).uniform(0, 1, (h, w, 3)).astype(np.float32)
    slam = SLAM(_backend_cfg(max_keyframes=8, max_edges=8, max_odom_edges=8), model, (h, w),
                use_backend=True, single_thread=True, device=device)
    flags = [slam.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))[::2] for i in range(5)]
    poses = slam.keyframe_poses()[1]
    out = flags, poses, list(slam.backend._pairs), slam.backend._n_odom
    slam.terminate()
    return out


def phase_backend_tiny():
    before = ba_reduce_kernel.ray_edge_systems.launches
    fl_g, P_g, pairs_g, n_odom_g = _tiny_backend(DEV)
    launched = ba_reduce_kernel.ray_edge_systems.launches - before
    fl_c, P_c, pairs_c, n_odom_c = _tiny_backend(torch.device("cpu"))
    diff = float(np.abs(P_g - P_c).max())
    emit("backend_tiny", flags_cuda=fl_g, flags_cpu=fl_c, pairs=pairs_g, n_odom=n_odom_g,
         pose_max_abs_diff=diff, ray_launches=launched)
    assert fl_g == fl_c and pairs_g == pairs_c and n_odom_g == n_odom_c == 4
    assert np.isfinite(P_g).all() and launched > 0
    np.testing.assert_allclose(P_g, P_c, atol=1e-4)


TINY_K = np.array([[60.0, 0.0, 32.0], [0.0, 60.0, 16.0], [0.0, 0.0, 1.0]])


def _tiny_calib(device):
    """Five identical frames through the calibrated tracker; each new
    keyframe's task runs the calibrated window solve."""
    model = _tiny_model(device)
    h, w = 32, 64
    img = np.random.default_rng(2).uniform(0, 1, (h, w, 3)).astype(np.float32)
    slam = SLAM(_backend_cfg(use_calib=True, max_keyframes=8, max_edges=8, max_odom_edges=8), model,
                (h, w), calib=TINY_K, use_backend=True, single_thread=True, device=device)
    solves = []
    real = slam.backend.solve_window_calib
    slam.backend.solve_window_calib = lambda *a, **k: solves.append(1) or real(*a, **k)
    flags = [slam.grab_rgb(img, timestamp=float(i))[::2] for i in range(5)]
    poses = slam.keyframe_poses()[1]
    slam.terminate()
    return flags, poses, len(solves)


def phase_calib_tiny():
    before = read_counts()
    fl_g, P_g, solves_g = _tiny_calib(DEV)
    launched = {k: v - before[k] for k, v in read_counts().items()}
    fl_c, P_c, solves_c = _tiny_calib(torch.device("cpu"))
    diff = float(np.abs(P_g - P_c).max())
    emit("calib_tiny", flags_cuda=fl_g, flags_cpu=fl_c, calib_solves=solves_g,
         pose_max_abs_diff=diff, launches=launched)
    assert fl_g == fl_c and all(f == (True, True) for f in fl_g)
    assert solves_g == solves_c == 4 and np.isfinite(P_g).all()
    assert launched["ray_edge_systems"] == 0, "the calibrated solve launched the ray kernel"
    assert launched["refine_matches"] > 0 and launched["flash_attention"] > 0, launched
    np.testing.assert_allclose(P_g, P_c, atol=1e-4)


def _instrument(slam, rec, timed):
    """Count GN iterations and ray-kernel launches per solve, on whichever
    thread runs it; with ``timed``, also time each backend stage between
    device-wide syncs. The threaded run is not timed so: a sync on the
    worker would stall the frontend's queued work, which production does
    not do."""
    be = slam.backend
    ray = ba_reduce_kernel.ray_edge_systems

    def wrap(stage, fn):
        def wrapper(*a, **k):
            if timed:
                torch.cuda.synchronize()
            t0, l0 = time.perf_counter(), ray.launches
            out = fn(*a, **k)
            r = dict(stage=stage)
            if timed:
                torch.cuda.synchronize()
                r["ms"] = (time.perf_counter() - t0) * 1e3
            if stage == "solve":
                r.update(be.last_solve, ray_launches=ray.launches - l0)
            rec.append(r)
            return out
        return wrapper

    be.add_consecutive_half = wrap("decode_match", be.add_consecutive_half)
    be.add_factors = wrap("decode_match", be.add_factors)
    be.solve_window_rays = wrap("solve", be.solve_window_rays)


def _backend_run(model, frames, single_thread, extra_pairs):
    failures = _Failures()
    logging.getLogger("frodo_slam_tpu_torch").addHandler(failures)
    slam = SLAM(_backend_cfg(), model, frames[0].shape[:2], use_backend=True,
                single_thread=single_thread)
    rec = []
    _instrument(slam, rec, timed=single_thread)
    at_start = reset_peak()
    zero_counts()
    ms, flags = [], []
    t_run = time.perf_counter()
    for i, img in enumerate(frames):
        t = time.perf_counter()
        ok, T, new_kf = slam.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))
        ms.append((time.perf_counter() - t) * 1e3)
        flags.append((ok, new_kf))
        assert np.isfinite(T).all()
    slam.terminate()  # threaded: drains the queue and joins the worker
    joined = slam._backend_worker is None and slam._backend_tasks.unfinished_tasks == 0
    run_s = time.perf_counter() - t_run
    if extra_pairs:
        n = slam.store.n_total
        slam.backend.add_factors(slam.store, [n - 2, 2], [n - 1, n - 1])  # one consecutive, one loop
        slam.backend.solve_GN_rays(slam.store)
    torch.cuda.synchronize()
    launches = read_counts()
    logging.getLogger("frodo_slam_tpu_torch").removeHandler(failures)
    poses = slam.keyframe_poses()[1]
    solves = [r for r in rec if r["stage"] == "solve"]
    out = dict(single_thread=single_thread, frames=len(frames), run_s=run_s,
               frame_ms=[round(x, 3) for x in ms], median_frame_ms_after_first=statistics.median(ms[1:]),
               decode_match_ms=[round(r["ms"], 3) for r in rec
                                if r["stage"] == "decode_match" and "ms" in r],
               solve_ms=[round(r["ms"], 3) for r in solves if "ms" in r],
               gn_iters=[r["iters"] for r in solves], ray_launches_per_solve=[r["ray_launches"] for r in solves],
               edge_rows=[r["edge_rows"] for r in solves], window_poses=[r["poses"] for r in solves],
               pairs=len(slam.backend._pairs), n_odom=slam.backend._n_odom, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(), allocated_at_start=at_start,
               joined=joined,
               backend_task_failures=failures.records, extra_pairs=extra_pairs,
               ok_new_kf=[sum(f[0] for f in flags), sum(f[1] for f in flags)])
    emit("backend_main", **out)
    assert not failures.records, f"backend tasks failed: {failures.records}"
    assert joined, "the threaded backend did not join"
    assert all(f == (True, True) for f in flags), flags
    assert np.isfinite(poses).all() and poses.shape == (len(frames), 8)
    assert launches["ray_edge_systems"] > 0, "the backend never launched the ray kernel"
    assert launches["refine_matches"] > 0, "the backend path never launched the refine kernel"
    assert launches["flash_attention"] > 0, "the backend path never launched the attention kernel"
    assert launches["ray_edge_systems"] == sum(out["gn_iters"]) == sum(out["ray_launches_per_solve"])
    assert len(solves) == len(frames) - 1 + int(extra_pairs)
    return out


def phase_backend_main(n_frames=12, hw=(288, 512), model_cfg=None):
    h, w = hw
    model = mast3r.init_model(model_cfg or mast3r.MASt3RConfig(), seed=0, device=DEV)
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    frames = smooth_random_frames(1, h, w, seed=3) * n_frames
    ser = _backend_run(model, frames, single_thread=True, extra_pairs=True)
    thr = _backend_run(model, frames, single_thread=False, extra_pairs=False)
    torch.cuda.empty_cache()
    return ser, thr


# ---------------------------------------------------------------------------
# dataset_main: the dataset runner on a TUM sequence, calibrated
# ---------------------------------------------------------------------------

def _write_tum(seq: pathlib.Path, n_images: int):
    """A TUM fr1 layout (rgb.txt + rgb/*.png) of ``n_images`` identical
    640x480 frames; fr1's distortion is undistorted under use_calib."""
    import PIL.Image

    (seq / "rgb").mkdir(parents=True, exist_ok=True)
    img = (smooth_random_frames(1, 480, 640, seed=3)[0] * 255).astype(np.uint8)
    lines = ["# color images", "# timestamp filename"]
    for i in range(n_images):
        ts = f"{1305031102.175304 + i / 30:.6f}"
        PIL.Image.fromarray(img).save(seq / "rgb" / f"{ts}.png")
        lines.append(f"{ts} rgb/{ts}.png")
    (seq / "rgb.txt").write_text("\n".join(lines) + "\n")


def phase_dataset_main(n_images=24, work=None):
    """``main.run`` as ``python -m frodo_slam_tpu_torch.main --dataset <seq>
    --config <cfg> --no-retrieval --save-as chip_smoke`` would run it, from
    ``work`` as the working directory (the runner writes logs/ there)."""
    work = pathlib.Path(work or ROOT / "build" / "chip_smoke")
    seq = work / "tum" / "rgbd_dataset_freiburg1_smoke"
    _write_tum(seq, n_images)
    cfg = work / "eval_calib_smoke.yaml"
    cfg.write_text("\n".join([f'inherit: "{ROOT / "configs" / "eval_calib.yaml"}"']
                             + [f"{k}: {json.dumps(v)}" for k, v in FORCE_KEYFRAMES.items()]) + "\n")
    args = types.SimpleNamespace(dataset=str(seq), config=str(cfg), calib=None, save_as="chip_smoke",
                                 no_viz=True, viz=False, weights=None, no_retrieval=True, max_frames=None)
    rec = dict(frame_ms=[], solve_ms=[], gn_iters=[], edge_rows=[], ray_solves=0)
    real = dict(grab=SLAM.grab_rgb, calib=BackendGraph.solve_window_calib,
                rays=BackendGraph.solve_window_rays)

    def grab(self, *a, **k):  # ends in the frame's flags fetch: no sync needed
        t = time.perf_counter()
        out = real["grab"](self, *a, **k)
        rec["frame_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def solve_calib(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["calib"](self, *a, **k)
        torch.cuda.synchronize()
        rec["solve_ms"].append((time.perf_counter() - t) * 1e3)
        rec["gn_iters"].append(self.last_solve["iters"] if out is not None else 0)
        rec["edge_rows"].append(self.last_solve["edge_rows"] if out is not None else 0)
        return out

    def solve_rays(self, *a, **k):
        rec["ray_solves"] += 1
        return real["rays"](self, *a, **k)

    SLAM.grab_rgb, BackendGraph.solve_window_calib, BackendGraph.solve_window_rays = (
        grab, solve_calib, solve_rays)
    cwd, env = os.getcwd(), os.environ.get("FRODO_RANDOM_SHARE_DECODER")
    os.environ["FRODO_RANDOM_SHARE_DECODER"] = "1"  # identical frames track (loader.py)
    try:
        os.chdir(work)
        at_start = reset_peak()
        zero_counts()
        t0 = time.perf_counter()
        out = runner.run(args, device=DEV)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        os.chdir(cwd)
        SLAM.grab_rgb, BackendGraph.solve_window_calib, BackendGraph.solve_window_rays = (
            real["grab"], real["calib"], real["rays"])
        if env is None:
            os.environ.pop("FRODO_RANDOM_SHARE_DECODER", None)
        else:
            os.environ["FRODO_RANDOM_SHARE_DECODER"] = env
    traj = work / out["traj"]
    rows = np.loadtxt(traj, ndmin=2)
    ply = (work / out["ply"]).read_bytes()
    n_vertex = int(ply.split(b"element vertex ")[1].split(b"\n")[0])
    pngs = sorted((work / out["keyframes"]).glob("*.png"))
    frame_ms, solve_ms = rec["frame_ms"], rec["solve_ms"]
    r = dict(frames=len(frame_ms), keyframes=int(rows.shape[0]), image_hw=[384, 512], run_s=run_s,
             frame_ms=[round(x, 3) for x in frame_ms],
             median_frame_ms_after_first=statistics.median(frame_ms[1:]),
             solve_ms=[round(x, 3) for x in solve_ms], gn_iters=rec["gn_iters"], edge_rows=rec["edge_rows"],
             median_solve_ms=statistics.median(solve_ms) if solve_ms else None,
             ray_solves=rec["ray_solves"],
             max_memory_allocated=torch.cuda.max_memory_allocated(), allocated_at_start=at_start,
             launches=launches, ply_vertices=n_vertex, keyframe_pngs=len(pngs))
    emit("dataset_main", **r)
    assert rows.shape == (n_images // 2, 8) and np.isfinite(rows).all(), rows.shape
    assert len(pngs) == rows.shape[0] and n_vertex > 0
    assert len(solve_ms) == rows.shape[0] - 1 and r["ray_solves"] == 0
    assert launches["flash_attention"] > 0 and launches["refine_matches"] > 0, launches
    assert launches["ray_edge_systems"] == 0, "the calibrated path launched the ray kernel"
    return r


# ---------------------------------------------------------------------------
# reloc_main: retrieval loop closure and relocalization at full width
# ---------------------------------------------------------------------------

# With random weights and shared decoders only an identical image matches
# projectively; the tracker's fnn fallback finds ~0.0145 of the pixels on a
# pan of one step, under 0.009 on seven, none on a blank frame (the
# per-frame fractions are printed). So min_match_frac 0.3 sends every
# distinct frame to the fallback, which accepts at 0.011; loop-closure and
# relocalization pairs pass their projective gates only between identical
# images. The random head and codebook rank places poorly (an image's own
# keyframe need not rank first, and the early keyframes top most queries),
# so retrieval keeps ten keyframes, and a relocalization needs one
# retrieved keyframe to match, not all: strict off.
RELOC_CFG = dict(
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.3, "Q_conf": 0.0, "max_iters": 10,
              "use_fnn": True, "min_match_frac_fnn": 0.011},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.1},
    retrieval={"k": 10},
    reloc={"strict": False})
RELOC_STEP = 32  # pixels the camera pans between frames
RELOC_WORDS = 65536  # the codebook of record (retrieval/asmk.py)


def reloc_frames(h, w, n_out=10, back_to=7, n_blank=2, step=RELOC_STEP):
    """(crop index or -1, image) per frame: out over crops 0 .. n_out - 1,
    back over n_out - 2 .. back_to (revisits), ``n_blank`` blank frames (a
    covered camera; fewer than the losses that reset the map), then crop 0
    again: the map's first image, seven steps from the active keyframe, too
    far to track."""
    pano = smooth_random_frames(1, h, w + step * n_out, seed=3)[0]
    crop = lambda t: np.ascontiguousarray(pano[:, t * step: t * step + w])  # noqa: E731
    seq = [(t, crop(t)) for t in range(n_out)] + [(t, crop(t)) for t in range(n_out - 2, back_to - 1, -1)]
    return seq + [(-1, np.zeros((h, w, 3), np.float32))] * n_blank + [(0, crop(0))]


def phase_host_kernels(dim=1024, nfeat=300, seed=0):
    """The host popcount library against its numpy plain versions at the
    query's shapes: pack nfeat x dim residuals, hamming against a word's
    entries, accumulate alpha = 3 scores; bitwise, and 1e-12 for scores."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(nfeat, dim)).astype(np.float32)
    t0 = time.perf_counter()
    packed = native.binarize_and_pack_2d(vecs)
    pack_ms = (time.perf_counter() - t0) * 1e3
    db = asmk.binarize_and_pack_plain(rng.normal(size=(64, dim)).astype(np.float32))
    imids = rng.integers(0, 16, size=64).astype(np.int64)
    norm = rng.integers(1, 300, size=16).astype(np.float64)
    got, want = np.zeros(16), np.zeros(16)
    native.asmk_accumulate_word(packed[0], db, imids, dim, 0.0, norm, got)
    asmk.asmk_accumulate_word_plain(packed[0], db, imids, dim, 0.0, norm, want)
    r = dict(pack_equal=bool(np.array_equal(packed, asmk.binarize_and_pack_plain(vecs))),
             hamming_equal=bool(np.array_equal(native.hamming_cdist_packed(packed, db, dim),
                                               asmk.hamming_cdist_packed_plain(packed, db, dim))),
             scores_max_abs_err=float(np.abs(got - want).max()), pack_ms=pack_ms)
    emit("host_kernels", **r)
    if not (r["pack_equal"] and r["hamming_equal"] and r["scores_max_abs_err"] <= 1e-12):
        raise AssertionError(f"the host popcount kernels disagree with their plain versions: {r}")
    return r


def run_reloc(model, h, w, n_words=RELOC_WORDS, nfeat=300, device=DEV):
    """The reloc_main sequence through threaded SLAM; returns what it saw.
    Every retrieval update is timed on the host (it ends in the fetch of
    its features), split into the query and the insert it made."""
    enc = model.cfg.enc_embed_dim
    head = RetrievalHead.init(torch.Generator().manual_seed(1), backbone_dim=enc, hdims=[min(1024, enc)],
                              nfeat=nfeat, device=device)
    codebook = asmk.Codebook.random(np.random.default_rng(0), n_words, head.dim, device=device)
    db = RetrievalDatabase(head, codebook, degraded=True)
    failures = _Failures()
    logging.getLogger("frodo_slam_tpu_torch").addHandler(failures)
    slam = SLAM(make_config(**RELOC_CFG), model, (h, w), retrieval_db=db, use_backend=True,
                use_reloc=True, single_thread=False, device=device)
    updates, inserts, relocs = [], [], []
    real_update, real_add, real_reloc = db.update, db._add, slam._relocalize

    def update(feat, add_after_query, k, min_thresh=0.0, kf_id=None):
        n, t0 = len(inserts), time.perf_counter()
        out = real_update(feat, add_after_query, k, min_thresh=min_thresh, kf_id=kf_id)
        ms = (time.perf_counter() - t0) * 1e3
        ins = inserts[n] if len(inserts) > n else 0.0
        updates.append(dict(kf_id=kf_id, add=bool(add_after_query), result=[int(i) for i in out], ms=ms,
                            insert_ms=ins, query_ms=ms - ins))
        return out

    def add(*a, **k):
        t0 = time.perf_counter()
        real_add(*a, **k)
        inserts.append((time.perf_counter() - t0) * 1e3)

    def reloc(frame, timestamp):
        t0 = time.perf_counter()
        out = real_reloc(frame, timestamp)
        relocs.append((timestamp, bool(out), (time.perf_counter() - t0) * 1e3))
        return out

    db.update, db._add, slam._relocalize = update, add, reloc
    seq = reloc_frames(h, w)
    at_start = reset_peak() if device.type == "cuda" else 0
    zero_counts()
    frames, crop_of_kf = [], []
    t_run = time.perf_counter()
    for i, (t, img) in enumerate(seq):
        n_kf = len(slam.kf_timestamps)
        ok, T, new_kf = slam.grab_rgb(img, timestamp=float(i))
        fl = slam.last_track.flags.cpu().numpy() if i else np.zeros(20)
        frames.append(dict(crop=t, ok=bool(ok), new_kf=bool(new_kf), match_frac=float(fl[0]),
                           fnn=bool(fl[19] > 0), finite=bool(np.isfinite(T).all())))
        crop_of_kf += [t] * (len(slam.kf_timestamps) - n_kf)
    slam.terminate()
    run_s = time.perf_counter() - t_run
    launches = read_counts()
    logging.getLogger("frodo_slam_tpu_torch").removeHandler(failures)
    pairs = list(slam.backend._pairs)
    loops = [(i, j) for i, j in pairs if abs(j - i) > 1]
    return dict(frames=frames, updates=updates, relocs=relocs, pairs=pairs, loop_edges=loops,
                same_image_loop_edges=[(i, j) for i, j in loops if crop_of_kf[i] == crop_of_kf[j]],
                crop_of_kf=crop_of_kf, atlas=len(slam.atlas), launches=launches, run_s=run_s,
                backend_task_failures=failures.records, allocated_at_start=at_start,
                poses_finite=bool(np.isfinite(slam.keyframe_poses()[1]).all()))


def phase_reloc_main(h=288, w=512):
    host = phase_host_kernels()
    model = mast3r.init_model(mast3r.MASt3RConfig(), seed=0, device=DEV)
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    r = run_reloc(model, h, w)
    q = [u["query_ms"] for u in r["updates"] if u["kf_id"] != 0]  # the first keyframe queries nothing
    ins = [u["insert_ms"] for u in r["updates"] if u["add"]]
    out = dict(image_hw=[h, w], n_words=RELOC_WORDS, nfeat=300, head=[1024, 1024], **r,
               query_ms_median=statistics.median(q), insert_ms_median=statistics.median(ins),
               reloc_ms=[ms for _, _, ms in r["relocs"]],
               max_memory_allocated=torch.cuda.max_memory_allocated(), host_kernels=host)
    emit("reloc_main", **{k: v for k, v in out.items() if k != "pairs"}, n_pairs=len(r["pairs"]))
    f = r["frames"]
    assert not r["backend_task_failures"], f"backend tasks failed: {r['backend_task_failures']}"
    assert all(x["finite"] for x in f) and r["poses_finite"]
    blank = [x for x in f if x["crop"] == -1]
    assert all(x["ok"] and x["new_kf"] for x in f[:-len(blank) - 1]), "the pan did not track as keyframes"
    assert blank and not any(x["ok"] for x in blank), "a blank frame tracked"
    assert f[-1]["ok"] and not f[-1]["new_kf"], "the last frame did not relocalize"
    assert [ok for _, ok, _ in r["relocs"]] == [False] * len(blank) + [True], r["relocs"]
    assert r["atlas"] == 0, "the map reset"
    assert r["same_image_loop_edges"], f"no retrieved revisit became a loop edge: {r['loop_edges']}"
    for name in WRAPPERS:
        assert r["launches"][name] > 0, f"reloc_main never launched {name}"
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# synthetic: the oracle harness on the card
# ---------------------------------------------------------------------------

SYNTH_ROWS = [("straight", ["--frames", "10", "--noise", "0.003"]),
              ("per_frame", ["--per-frame", "--frames", "10", "--noise", "0.003"]),
              ("loop", ["--loop", "--frames", "14", "--noise", "0.004"])]


def phase_synthetic():
    """Each row in a subprocess (the oracle patches the model module-wide),
    held to the JAX package's bars (tests/test_synthetic_e2e.py)."""
    rows, launches = {}, {"refine_matches": 0, "ray_edge_systems": 0, "flash_attention": 0}
    for name, args in SYNTH_ROWS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "frodo_slam_tpu_torch.tools.eval_synthetic",
                               "--device", "cuda", *args], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"synthetic {name} failed:\n{proc.stderr[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["wall_s"] = time.perf_counter() - t0
        for k, v in out.pop("launches").items():
            launches[k] += v
        rows[name] = out
        emit("synthetic", row=name, **out)
    s, pf, lp = rows["straight"], rows["per_frame"], rows["loop"]
    on, off = lp["loop"], lp["no_retrieval"]
    assert s["frames_tracked_ok"] == 10 and s["n_kf"] == 10 and s["ate_rmse"] < 0.05, s
    assert pf["frames_tracked_ok"] == 10 and pf["n_kf"] < 10 and pf["ate_rmse"] < 0.05, pf
    assert on["frames_tracked_ok"] == off["frames_tracked_ok"] == 14, lp
    assert on["n_long_loop_edges"] >= 1 and off["n_loop_edges"] == 0, lp
    assert on["ate_rmse"] <= off["ate_rmse"] * 1.05, lp
    assert launches["refine_matches"] > 0 and launches["ray_edge_systems"] > 0, launches
    return rows, launches


def main():
    t_start = time.perf_counter()
    set_f32_contract()
    phase_device()
    phase_build()
    refine = phase_refine()
    attn = phase_attention()
    phase_tiny()
    main_launches, _ = phase_main()
    per_ray = phase_ray_reduce()
    phase_backend_tiny()
    phase_calib_tiny()
    ser, thr = phase_backend_main()
    ds = phase_dataset_main()
    reloc = phase_reloc_main()
    _, synth = phase_synthetic()
    # the ray kernel's time on the window case of the edge rows the backend
    # path handed it last
    E_main = ser["edge_rows"][-1]
    ray_t = per_ray[{16: "win16_8p", 32: "win32_11p"}.get(E_main, f"all{E_main}")]
    rt = refine["384x512"]
    at = attn[0]  # the encoder at 768 tokens: (1, 16, 768, 64) bf16
    per_path = lambda name: {"main": main_launches[name],  # noqa: E731
                             "backend_main": [ser["launches"][name], thr["launches"][name]],
                             "dataset_main": ds["launches"][name],
                             "reloc_main": reloc["launches"][name],
                             "synthetic": synth[name]}
    kernels = [{
        "name": "refine_matches",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/refine_matches.cu",
        "replaces": "frodo_slam_tpu/ops/refine_fused_pallas.py:303",
        "also_replaces": "frodo_slam_tpu/ops/refine_fused_pallas.py:322",
        "launches": ds["launches"]["refine_matches"],
        "launches_per_path": per_path("refine_matches"),
        "shape": rt["shape"],
        "equal_to_plain": True,
        "max_abs_err": rt["max_abs_err"],
        "ms": rt["ms"],
        "ms_smooth": rt["ms_smooth"],
        "plain_ms": rt["plain_ms"],
        "bound_ms": rt["bound_ms"],
        "bound_by": rt["bound_by"],
        "library_ms": None,
        "per_shape": {k: {f: v[f] for f in ("ms", "ms_smooth", "ms_collisions", "plain_ms", "bound_ms",
                                            "bound_by")}
                      for k, v in refine.items()},
    }, {
        "name": "ray_edge_systems",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/ray_edge_systems.cu",
        "replaces": "frodo_slam_tpu/ops/ba_reduce_pallas.py:201",
        "launches": ser["launches"]["ray_edge_systems"],
        "launches_per_path": per_path("ray_edge_systems"),
        "shape": [E_main, ray_t["N"]],
        "case": ray_t["case"],
        "max_abs_err": ray_t["max_abs_err_f32"],
        "max_rel_err": ray_t["err_f32"],
        "ms": ray_t["device_ms"],
        "single_ms": ray_t["single_ms"],
        "plain_ms": ray_t["plain_ms"],
        "bound_ms": ray_t["bound_ms"],
        "bound_by": ray_t["bound_by"],
        "library_ms": None,
        "per_case": {c: {k: v[k] for k in ("E", "A", "D", "device_ms", "single_ms", "plain_ms", "f64_device_ms",
                                           "bound_ms", "err_f32", "err_f64")} for c, v in per_ray.items()},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/flash_attention.cu",
        "replaces": "frodo_slam_tpu/models/layers.py:161",
        "replaces_kernel": "jax.experimental.pallas.ops.tpu.flash_attention."
                           "_flash_attention_kernel_single_batch",
        "launches": ds["launches"]["flash_attention"],
        "launches_per_path": per_path("flash_attention"),
        "shape": at["shape"],
        "max_abs_err": max(a["max_abs_err"] for a in attn if a["dtype"] == "bfloat16"),
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "per_shape": {"x".join(map(str, a["shape"])) + "_" + a["dtype"]:
                      {f: a[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "bar")}
                      for a in attn},
    }]
    emit("total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
