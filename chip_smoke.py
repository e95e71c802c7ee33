#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (one JSON line each; any failure exits nonzero, nothing is caught):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: every hand-written kernel compiled from csrc/ with nvcc, one
     nvcc per source, all started together;
  3. refine: the Hopper refine kernel vs its bf16 plain version at the
     dataset path's shape (1, 384, 512, 24) and at (1, 288, 512, 24),
     radius 3, dilation 5, on two seed sets each; bitwise equal; kernel and
     plain times (CUDA events, median of 20); the bound (bytes / 3.35 TB/s
     vs operations / peak);
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
     N = 147,456 points per edge (and one N off the chunk size), E edges in
     {16, 32, 128, 512}, zero-weight rows included: f32 kernel vs f64 plain
     within 1e-4 of each edge's largest entry, f64 kernel within 1e-10; two
     calls bitwise equal; kernel, f64 kernel and plain times (median of 20)
     beside the bound;
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
     per-solve ms, peak memory;
 12. the script's wall time; the kernels line; the device line (last line
     of stdout).

On every path (6, 10 and 11) the kernel launch counters are zeroed just
before it and read just after; each path must launch each of its kernels.

Without a card, or without the rest of the repository beside it, it exits
nonzero before printing any result.
"""

from __future__ import annotations

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


def emit(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


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


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(lambda mod: mod.build(), KERNELS))
    for mod, (seconds, log) in zip(KERNELS, results):
        emit("ptxas", kernel=mod.__name__, seconds=round(seconds, 3),
             log=[ln for ln in log.splitlines() if "registers" in ln or "spill" in ln])
    emit("build", seconds=round(time.perf_counter() - t0, 3))


def _refine_inputs(seed, h=288, w=512, f=24, collide=False):
    """Descriptors at the main path's refine shape; query k is a noisy copy
    of D11 at its own pixel. Seeds: that pixel plus a random +-20 px offset,
    or (``collide``) snapped to a 4x4 grid so 16 queries share each seed."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    D11 = torch.randn((1, h, w, f), generator=g, device=DEV)
    D11 = D11 / D11.norm(dim=-1, keepdim=True)
    n = h * w
    grid = torch.stack(torch.meshgrid(torch.arange(w, device=DEV), torch.arange(h, device=DEV),
                                      indexing="xy"), -1).reshape(1, n, 2)
    D21 = D11.reshape(1, n, f) + 0.05 * torch.randn((1, n, f), generator=g, device=DEV)
    if collide:
        p1 = torch.div(grid, 4, rounding_mode="floor") * 4
    else:
        p1 = grid + torch.randint(-20, 21, (1, n, 2), generator=g, device=DEV)
    lim = torch.tensor([w - 1, h - 1], device=DEV)
    return D11, D21, torch.minimum(p1.clamp(min=0), lim).to(torch.int32)


# the dataset path's grid (512x384 frames) first, then the 288x512 paths
REFINE_SHAPES = [(384, 512), (288, 512)]


def _refine_at(h, w, radius=3, dmax=5):
    max_err = 0.0
    probes = 0
    cases = {"identity_pm20": _refine_inputs(0, h, w), "collisions": _refine_inputs(1, h, w, collide=True)}
    for name, (D11, D21, p1) in cases.items():
        pk, sk = refine_kernel.refine_matches(D11, D21, p1, radius, dmax)
        torch.cuda.synchronize()
        pp, sp, nprobe = refine_kernel.refine_matches_plain(D11, D21, p1, radius, dmax,
                                                             count_probes=True)
        equal = bool(torch.equal(pk, pp)) and bool(torch.equal(sk, sp))
        err = float((sk - sp).abs().max())
        uniq = int(torch.unique(p1[0, :, 0] + D11.shape[2] * p1[0, :, 1]).numel())
        emit("refine_check", shape=[h, w], case=name, equal=equal, max_abs_err=err, unique_seeds=uniq,
             moved=float((pk != p1).any(-1).float().mean()))
        if not equal:
            raise AssertionError(f"refine kernel != plain on {name} at {h}x{w}")
        max_err = max(max_err, err)
        probes = int(nprobe) if name == "identity_pm20" else probes
    D11, D21, p1 = cases["identity_pm20"]
    ms = cuda_ms(lambda: refine_kernel.refine_matches(D11, D21, p1, radius, dmax))
    plain_ms = cuda_ms(lambda: refine_kernel.refine_matches_plain(D11, D21, p1, radius, dmax))
    n = p1.shape[1]
    # each f32 input read once, each output written once
    nbytes = D11.numel() * 4 + D21.numel() * 4 + p1.numel() * 4 + n * 2 * 4 + n * 4
    # the dots this input needs: 2 ops per channel per in-image probe, over
    # bf16 values (the kernel's contract), at the bf16 peak
    ops = 2 * D11.shape[-1] * probes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    out = dict(shape=[h, w], ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops, probes=probes,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=max_err)
    emit("refine_time", **out)
    return out


def phase_refine():
    return {f"{h}x{w}": _refine_at(h, w) for h, w in REFINE_SHAPES}


# ---------------------------------------------------------------------------
# attention: the flash-attention kernel vs its plain version
# ---------------------------------------------------------------------------

# (B, H, Nq, Nk, D, dtype): the encoder at 512x384 and 288x512, the two
# decoders batched, a ragged N, the backend's pair batch; f32 at head dim 32
ATTN_SHAPES = [(1, 16, 768, 768, 64, torch.bfloat16), (2, 12, 768, 768, 64, torch.bfloat16),
               (1, 16, 576, 576, 64, torch.bfloat16), (1, 16, 700, 700, 64, torch.bfloat16),
               (4, 12, 768, 768, 64, torch.bfloat16), (1, 12, 768, 640, 64, torch.bfloat16),
               (2, 2, 96, 96, 32, torch.float32), (1, 2, 100, 77, 24, torch.float32)]
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
        g = torch.Generator(device=DEV).manual_seed(100 + i)
        q = (2.0 * torch.randn((B, H, Nq, D), generator=g, device=DEV)).to(dt)
        k = torch.randn((B, H, Nk, D), generator=g, device=DEV).to(dt)
        v = torch.randn((B, H, Nk, D), generator=g, device=DEV).to(dt)
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
    torch.cuda.reset_peak_memory_stats()
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
         max_memory_allocated=peak, counts=counts, launches=launches,
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


def _ray_inputs(seed, E, N):
    """A seeded device world: per-edge relative Sim(3)s near identity,
    points around z = 5, weights in [0, 2) with a zeroed tenth of every edge
    and one fully masked edge."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    xi = 0.05 * torch.randn((E, 7), generator=g, device=DEV, dtype=torch.float64)
    T = lie.sim3_exp(xi)
    sR = T[:, 7, None, None] * lie.quat_to_R(T[:, 3:7])
    scal = torch.cat([sR.reshape(E, 9), T[:, :3]], dim=-1).float()
    off = torch.tensor([0.0, 0.0, 5.0], device=DEV)[None, :, None]
    XiT = torch.randn((E, 3, N), generator=g, device=DEV) + off
    XjT = XiT + 0.05 * torch.randn((E, 3, N), generator=g, device=DEV)
    w0 = 2 * torch.rand((E, N), generator=g, device=DEV)
    w0[:, : N // 10] = 0.0
    w0[-1] = 0.0
    return scal, XiT, XjT, w0


def _rel_err(got, want):
    """Largest per-edge |got - want| over that edge's largest |entry|."""
    E = want.shape[0]
    scale = want.reshape(E, -1).abs().amax(1).clamp(min=1e-300)
    return float(((got.double() - want).reshape(E, -1).abs().amax(1) / scale).max())


def ray_bound(E, N, nbytes_per_scalar=4):
    """Least time for one call: inputs read once (Xi, Xj, w0 per point; the
    12 scalars per edge), outputs written once (B, g), vs the operations at
    the f32 (or f64) peak outside the tensor cores."""
    nbytes = nbytes_per_scalar * (E * N * 7 + E * 12 + E * 56)
    ops = E * N * ba_reduce_kernel.FLOPS_PER_POINT
    peak = F32_OPS_PER_S if nbytes_per_scalar == 4 else F64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_ray_reduce(Es=(16, 32, 128, 512), N=147456):
    rk = ba_reduce_kernel
    per_E = {}
    cases = [(E, N) for E in Es] + [(16, N - 333)]  # the last: N off the 4096-point chunk
    for k, (E, n) in enumerate(cases):
        scal, XiT, XjT, w0 = _ray_inputs(k, E, n)
        B32, g32 = rk.ray_edge_systems(scal, XiT, XjT, w0, **RAY_KW)
        B32b, g32b = rk.ray_edge_systems(scal, XiT, XjT, w0, **RAY_KW)
        d64 = tuple(a.double() for a in (scal, XiT, XjT, w0))
        B64, g64 = rk.ray_edge_systems(*d64, **RAY_KW)
        B64b, g64b = rk.ray_edge_systems(*d64, **RAY_KW)
        torch.cuda.synchronize()
        Bp, gp = rk.ray_edge_systems_plain(*d64, **RAY_KW)
        out = dict(E=E, N=n,
                   err_f32=max(_rel_err(B32, Bp), _rel_err(g32, gp)),
                   err_f64=max(_rel_err(B64, Bp), _rel_err(g64, gp)),
                   max_abs_err_f32=float(max((B32.double() - Bp).abs().max(),
                                             (g32.double() - gp).abs().max())),
                   repeatable=bool(torch.equal(B32, B32b) and torch.equal(g32, g32b)
                                   and torch.equal(B64, B64b) and torch.equal(g64, g64b)),
                   masked_edge_zero=bool(torch.count_nonzero(B32[-1]) == 0
                                         and torch.count_nonzero(g32[-1]) == 0))
        del d64, Bp, gp
        if n == N:
            out["ms"] = cuda_ms(lambda: rk.ray_edge_systems(scal, XiT, XjT, w0, **RAY_KW))
            out["plain_ms"] = cuda_ms(lambda: rk.ray_edge_systems_plain(scal, XiT, XjT, w0, **RAY_KW))
            X64 = tuple(a.double() for a in (scal, XiT, XjT, w0))
            out["f64_ms"] = cuda_ms(lambda: rk.ray_edge_systems(*X64, **RAY_KW))
            out["f64_bound_ms"] = ray_bound(E, n, 8)["bound_ms"]
            del X64
            out.update(ray_bound(E, n))
            per_E[E] = out
        emit("ray_reduce", **out)
        if not (out["err_f32"] <= 1e-4 and out["err_f64"] <= 1e-10):
            raise AssertionError(f"ray kernel disagrees with its plain version at E={E}, N={n}")
        if not (out["repeatable"] and out["masked_edge_zero"]):
            raise AssertionError(f"ray kernel not repeatable or masked edge not 0 at E={E}, N={n}")
        del scal, XiT, XjT, w0
        torch.cuda.empty_cache()
    return per_E


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
               max_memory_allocated=torch.cuda.max_memory_allocated(), joined=joined,
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
    rec = dict(frame_ms=[], solve_ms=[], gn_iters=[], ray_solves=0)
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
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
             solve_ms=[round(x, 3) for x in solve_ms], gn_iters=rec["gn_iters"],
             median_solve_ms=statistics.median(solve_ms) if solve_ms else None,
             ray_solves=rec["ray_solves"],
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
             ply_vertices=n_vertex, keyframe_pngs=len(pngs))
    emit("dataset_main", **r)
    assert rows.shape == (n_images // 2, 8) and np.isfinite(rows).all(), rows.shape
    assert len(pngs) == rows.shape[0] and n_vertex > 0
    assert len(solve_ms) == rows.shape[0] - 1 and r["ray_solves"] == 0
    assert launches["flash_attention"] > 0 and launches["refine_matches"] > 0, launches
    assert launches["ray_edge_systems"] == 0, "the calibrated path launched the ray kernel"
    return r


def main():
    t_start = time.perf_counter()
    set_f32_contract()
    phase_device()
    phase_build()
    refine = phase_refine()
    attn = phase_attention()
    phase_tiny()
    main_launches, _ = phase_main()
    per_E = phase_ray_reduce()
    phase_backend_tiny()
    phase_calib_tiny()
    ser, thr = phase_backend_main()
    ds = phase_dataset_main()
    # the ray kernel's time at the edge count the backend path handed it last
    E_main = ser["edge_rows"][-1]
    ray_t = per_E[E_main]
    rt = refine["384x512"]
    at = attn[0]  # the encoder at 768 tokens: (1, 16, 768, 64) bf16
    per_path = lambda name: {"main": main_launches[name],  # noqa: E731
                             "backend_main": [ser["launches"][name], thr["launches"][name]],
                             "dataset_main": ds["launches"][name]}
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
        "plain_ms": rt["plain_ms"],
        "bound_ms": rt["bound_ms"],
        "bound_by": rt["bound_by"],
        "library_ms": None,
        "per_shape": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
                      for k, v in refine.items()},
    }, {
        "name": "ray_edge_systems",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/ray_edge_systems.cu",
        "replaces": "frodo_slam_tpu/ops/ba_reduce_pallas.py:201",
        "launches": ser["launches"]["ray_edge_systems"],
        "launches_per_path": per_path("ray_edge_systems"),
        "shape": [E_main, ray_t["N"]],
        "max_abs_err": ray_t["max_abs_err_f32"],
        "max_rel_err": ray_t["err_f32"],
        "ms": ray_t["ms"],
        "plain_ms": ray_t["plain_ms"],
        "bound_ms": ray_t["bound_ms"],
        "bound_by": ray_t["bound_by"],
        "library_ms": None,
        "per_E": {str(E): {k: v[k] for k in ("ms", "plain_ms", "f64_ms", "bound_ms", "f64_bound_ms",
                                             "err_f32", "err_f64")} for E, v in per_E.items()},
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
