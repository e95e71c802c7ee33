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
  4b. rope: the RoPE2D kernel vs its plain twin at the model's shapes (the
     qkv split of the encoder and the decoders at 768 and 576 tokens, the
     cross-attention projections, the backend's batches, a tp shard, f32 at
     head dims 32 and 24): bitwise equal; kernel, plain-twin and per-call
     (the former path: tables rebuilt, eager rotation) device ms and host
     us per attention beside the byte bound; the table build's; then the
     ViT-L frontend's encode and pair decode at 288x512 under a profiler:
     one launch per attention (24 and 48), counted by ``model.rope_launches``;
  4c. resample: a frame's resize, crop and ImgNorm on the card
     (``ops/resample_kernel.py``) through ``system.preprocess_to_device``
     against the host path ``preprocess_image`` (PIL) on the frames of
     tools/kernel_cases.py (480x640, 360x640, 720x1280 to the 512 side;
     random, all 0, all 255, a one-pixel checkerboard): bitwise equal, two
     launches a frame; kernel device ms and host us, the whole call's host
     ms (pinned upload and launches) against the host path's, beside the
     byte bound;
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
  7b. calib: the calibrated edge kernel vs its plain version at the tum
     cells' window buckets (tools/kernel_cases.py: 16, 32 and 64 rows with
     a live prefix of consecutive pairs, N = 196,608 at 384x512, masked
     points of every kind): f32 kernel vs f64 plain within 1e-4 of each
     live edge's largest entry, f64 kernel within 1e-9; inactive rows
     exactly 0; two calls bitwise equal; one launch a call; device ms
     (queued calls), single-call ms, host us, f64 device ms and the f32
     plain twin's ms beside the bound; then a traced run of the cell
     tum384.kf-every: ``backend.calib_launches`` over
     ``backend.solve_iters`` must be 1.0, ``backend.step_replays`` over it
     at least 0.95 with no ``backend.step_captures`` (the warm-up session
     captured every window shape), and the run correct;
  8. backend_tiny: SLAM(use_backend=True) with odometry at tiny_config on
     the card vs the same on the CPU: flags equal, keyframe poses atol 1e-4;
  9. calib_tiny: the same with a calibration (calibrated tracker and window
     solve), under a profiler: flags equal, keyframe poses atol 1e-4, no
     ray-kernel launch, one calibrated edge-kernel launch a GN iteration
     (each solve's ``backend.calib_launches`` equal to its
     ``backend.solve_iters`` on the card, 0 on the CPU);
 10. vio_tiny: SLAM(local_opt_mode=True) at tiny_config with the height
     prior on, twelve identical frames and 1 cm of odometry a frame, on the
     card vs the CPU: flags equal, keyframe poses and scale channels atol
     1e-4, the PGO's solve within 1e-6 of its ring solved on the CPU and
     the run's PGO scale within 1e-4 relative; one more window solve with
     explicit live scale targets (atol 1e-4); a checkpoint round trip on the
     card;
 11. backend_main: ViT-L 288x512 with shared heads and decoders (so that
     identical frames track), 12 identical frames, every frame a keyframe,
     production capacities, an odometry pose per frame, once serialized and
     once threaded; then one add_factors of two pairs (one a loop closure)
     and a window solve. Per-frame ms, per-task decode+match and solve ms
     (serialized run only: its stages are timed between syncs), GN
     iterations, GN step replays and captures and ray-kernel launches per
     solve, edges, peak memory; any backend task that failed (the worker
     logs it) fails the phase. Then the serialized run's window, its
     odometry rows dropped (they keep the eager chain) and its poses
     perturbed, solved twice with the GN step as a CUDA graph and once
     eagerly: equal iterations, the second graphed solve a replay an
     iteration and no capture, poses within GRAPH_SOLVE_BAR of the eager;
 12. placement_main: the multi-card placement on aliases of the one card.
     What ``default_placement`` makes of this machine's cards (None at one
     card). ViT-L 288x512 with shared random decoders: one fixed batch of
     two pairs decoded split over a dp 2 x tp 2 grid of four aliases of
     cuda:0 against the unsplit bf16 decode and an f32 copy of the model
     (per output within 0.1 of its largest magnitude, and no further from
     the f32 decode than twice the unsplit one; attention at the tp shard's
     (2, 6, 576, 64)); then backend_main's 12 frames three times: unplaced
     serialized, ``shared`` dp 2 x tp 2 serialized, ``overlap`` (the tracker
     on slot 0, dp 2 x tp 1 on slots 1-2) threaded, each ending in three
     pairs padded over the ranks: the same keyframes and pairs, poses within
     1e-3 of the unplaced run, the ray kernel once a GN iteration and edge
     part; one window solve split over four edge parts against the unsplit
     solve of the same edges (1e-5). Frame, task and solve ms and peak
     memory, labelled as aliases of one card (no multi-card speed). With
     two cards, the bf16 attention on cuda:1 against its plain version;
     with one, a line saying why it did not run;
 13. dataset_main: the dataset runner, ``frodo_slam_tpu_torch.main.run``,
     on a TUM fr1 sequence that this script writes (24 identical 640x480
     PNGs under build/chip_smoke/), with a config that inherits
     configs/eval_calib.yaml (calibrated tracker and backend, subsample 2,
     serialized) and forces every tracked frame to a keyframe, ViT-L at
     512x384 with shared random decoders, --no-retrieval --save-as: finite
     trajectory rows, the .ply, one PNG per keyframe, one calibrated
     edge-kernel launch a GN iteration; per-frame and per-solve ms, edge
     rows per window, GN step replays and captures per solve, peak memory;
     the last window graphed against eager as in 11;
 14. realtime_main: the dataset runner with a config that inherits
     configs/realtime.yaml (bf16 heads, ``tpu.x64_eval: false``, the
     pipelined frontend) and forces every tracked frame to a keyframe, on 12
     identical 288x512 PNGs it writes, ViT-L with shared random decoders,
     --no-retrieval: the resolved numerics (x64 off, the f32 window solve
     with one refinement step), every solve in f32, every kernel launched;
     per-frame host ms, solve wall ms and GN iterations, peak memory;
 15. realtime_backend_main: backend_main's 12 frames threaded, once with
     ``tpu.x64_eval: false`` and once with it true, in one process: solve
     wall ms, GN iterations, step replays and captures and ray launches per
     solve in each, the largest pose difference between the two runs; the
     x64-off run's window graphed against eager as in 11, in f32 and in
     f64; then one window of the x64-off
     run (poses perturbed so that it iterates) solved on the card and on the
     CPU (plain versions) in each numerics, held within RT_SOLVE_BAR, with
     the card's solve ms in each;
 16. cli_fps_main: ``tools/cli_fps.py --frames 64`` on the card (the
     committed runner with configs/bench_cli.yaml, ViT-L 288x512, identical
     frames: the track-only regime); its JSON line as it prints it, the FPS
     windows, the runner's numerics (x64 off) and the kernels its process
     launched (counted in the child, zeroed when it starts);
 17. bench_main: ``python -m frodo_slam_tpu_torch.tools.bench`` (the port's
     counterpart of bench.py: pipelined and async passes, the keyframe
     policy with a cadence cap of 8, the 64-pose steady-state window solved
     in f32 at every keyframe, two decorrelated frames through the gate and
     the fnn fallback) at ViT-L 288x512 in a child process, threaded at 128
     frames and inline at 32; each tool line printed as it is and held (rc
     0, FPS > 0, TF32 off, backend work, 2 fnn frames and 2 gate misses,
     every kernel launched in the timed passes, a 128-row window), the
     kernels' launches as the tool counts them; then one solve of that
     window on the card (f32, the ray kernel) against the CPU's plain
     version within 5e-5, its ms, and the first ray-kernel call of the solve timed beside its bound;
 18. reloc_main: retrieval loop closure and relocalization through threaded
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
 19. vio_main: the VIO runner, ``frodo_slam_tpu_torch.run_vio.run_dataset``,
     on a recorded session that this script writes under build/chip_smoke/
     (16 identical 360x640 BGR frames, an odometry pose per frame,
     --use_odometry, every_n_frames 1), ViT-L at 288x512 with shared random
     decoders, a config that inherits configs/base_no_fnn.yaml, threaded,
     every frame a keyframe, the height prior on: finite metric keyframe
     poses, odometry factors, every kernel launched, no failed backend
     task; per-frame and per-task ms, the PGO's ms and live count, plane
     fits (rows, ms, live targets), peak memory;
 20. viz_main: the same run with ``--visualize``: the live map viewer on a
     free port while the backend worker writes the store in place; a client
     thread polls /state.json and /points.bin every 0.2 s, pauses the run
     after frame 4 (no frame for 1 s), steps exactly one frame, resumes, and
     is refused (403) from a foreign origin. Then a fresh viewer over the
     finished map must serve the store's live poses exactly, the backend's
     edges, and the points numpy recomputes from the store on the host
     (1e-5 relative to max(1, |x|)); no viewer error. Frame ms beside
     vio_main's, snapshots (host ms, bytes fetched), peak memory;
 21. codebook_main: ``python -m frodo_slam_tpu_torch.tools.train_codebook``
     (its ``main``) over 224 smooth random 288x512 PNGs it writes under
     build/chip_smoke/codebook/: the random-weight ViT-L encoder and the
     seeded retrieval head (1024 -> 1024, nfeat 300), 67,200 features,
     k-means to 65,536 words (20 iterations, batch 65,536). The card's
     k-means against the CPU's at 8,192 x 512 words x 5 iterations on the
     same draws (1e-5, >= 99.9% equal assignments); unit finite centroids;
     the pickle loads not degraded; a training image is retrieved first.
     Encode ms per image, k-means ms per iteration beside its f32 bound,
     attention launches (24 an image), peak memory;
 22. synthetic: the port's oracle harness (``python -m
     frodo_slam_tpu_torch.tools.eval_synthetic --device cuda``) in
     subprocesses: the straight row (10 frames at 3 mm), the --per-frame row
     (warm frames) and the loop row (14 frames at 4 mm, with and without
     retrieval) and the VIO row (16 frames at 2 mm, with and without
     odometry), each held to the JAX package's bars; ATEs and launches;
 23. the script's wall time; the kernels line; the device line (last line
     of stdout).

On every path (6, 11-22; each run of 11, 12, 15 and 17) the kernel launch
counters are zeroed just before it and read just after (17: by the tool, in
its process, around its two timed passes); each path must
launch each of its kernels (the oracle of 22 replaces the model: no
attention there; the trainer of 21 runs the encoder only: attention alone;
the track-only run of 16 makes no keyframe after the first, so no window
solve and no ray kernel).
Its peak memory window starts after a garbage collection, and the bytes
still allocated then are printed beside the peak.

Without a card, or without the rest of the repository beside it, it exits
nonzero before printing any result.
"""

from __future__ import annotations

import dataclasses
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
from frodo_slam_tpu_torch.ops import attention_kernel, ba_reduce_kernel, calib_edge_kernel, refine_kernel, resample_kernel, rope_kernel  # noqa: E402
from frodo_slam_tpu_torch.models import layers as layers_mod  # noqa: E402
from frodo_slam_tpu_torch.ops import lie  # noqa: E402
from frodo_slam_tpu_torch.ops.geometry import constrain_points_to_ray  # noqa: E402
from frodo_slam_tpu_torch.parallel import mesh  # noqa: E402
from frodo_slam_tpu_torch.slam import global_opt  # noqa: E402
from frodo_slam_tpu_torch.slam.inference import decode_symmetric_batch, decode_symmetric_split  # noqa: E402
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
KERNELS = [refine_kernel, ba_reduce_kernel, attention_kernel, rope_kernel,
           resample_kernel, calib_edge_kernel]  # every hand-written kernel module
# each kernel's counted wrapper: it adds one where it launches its kernel
# (the resample wrapper two: its two launches)
WRAPPERS = {"refine_matches": refine_kernel.refine_matches,
            "ray_edge_systems": ba_reduce_kernel.ray_edge_systems,
            "flash_attention": attention_kernel.flash_attention,
            "rope2d": rope_kernel.rope2d_,
            "resample": resample_kernel.resample,
            "calib_edge_systems": calib_edge_kernel.calib_edge_systems}
# the kernels every SLAM path launches; the resample kernel runs only on
# frames that need a resize (vio_main's and viz_main's 360x640 frames), the
# calibrated edge kernel only in calibrated window solves (calib_tiny,
# dataset_main)
PATH_KERNELS = ("refine_matches", "ray_edge_systems", "flash_attention", "rope2d")
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
# 32 and 24; the B = 1 decoder passes at 288x512 and 512x384; at 288x512
# the shapes placement_main gives it: a tp = 2 shard's 6 heads at B = 1 (a
# consecutive pair's missing direction), B = 2 (the fixed pair batch's one
# pair a rank) and B = 4 (the shared run's two extra pairs a rank, both
# directions), the overlap run's tp = 1 rank at B = 4 with 12 heads, and
# the unplaced run's three extra pairs at B = 6
ATTN_SHAPES = [(1, 16, 768, 768, 64, torch.bfloat16), (2, 12, 768, 768, 64, torch.bfloat16),
               (1, 16, 576, 576, 64, torch.bfloat16), (1, 16, 700, 700, 64, torch.bfloat16),
               (4, 12, 768, 768, 64, torch.bfloat16), (1, 12, 768, 640, 64, torch.bfloat16),
               (2, 2, 96, 96, 32, torch.float32), (1, 2, 100, 77, 24, torch.float32),
               (1, 12, 576, 576, 64, torch.bfloat16), (1, 12, 768, 768, 64, torch.bfloat16),
               (1, 6, 576, 576, 64, torch.bfloat16), (2, 6, 576, 576, 64, torch.bfloat16),
               (4, 6, 576, 576, 64, torch.bfloat16), (4, 12, 576, 576, 64, torch.bfloat16),
               (6, 12, 576, 576, 64, torch.bfloat16)]
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


# ---------------------------------------------------------------------------
# RoPE2D: the kernel vs its plain twin
# ---------------------------------------------------------------------------

# (B, H, Nq, Nk, D, dtype, layout; tools/kernel_cases.rope_case): the
# encoder's and the decoders' qkv split at 768 and 576 tokens, the decoders'
# cross-attention projections, the backend's pair batches, a tp = 2 shard;
# f32 at head dims 32 and 24 (the tiny configurations)
ROPE_SHAPES = [(1, 16, 768, 768, 64, torch.bfloat16, "qkv"), (1, 16, 576, 576, 64, torch.bfloat16, "qkv"),
               (1, 12, 768, 768, 64, torch.bfloat16, "qkv"), (1, 12, 768, 768, 64, torch.bfloat16, "proj"),
               (1, 12, 576, 576, 64, torch.bfloat16, "qkv"), (1, 12, 576, 576, 64, torch.bfloat16, "proj"),
               (2, 12, 768, 768, 64, torch.bfloat16, "qkv"), (4, 12, 576, 576, 64, torch.bfloat16, "proj"),
               (1, 6, 576, 576, 64, torch.bfloat16, "qkv"), (2, 2, 96, 96, 32, torch.float32, "qkv"),
               (1, 2, 100, 77, 24, torch.float32, "proj")]


def rope_bound(B, H, Nq, Nk, D, dtype, layout):
    """Least time for one call: q and k read and written once, their tables
    read once (one table for the qkv split); bytes over the memory rate."""
    esize = torch.tensor([], dtype=dtype).element_size()
    tables = B * (Nq if layout == "qkv" else Nq + Nk) * 4 * (D // 2)
    nbytes = esize * (2 * B * H * (Nq + Nk) * D + tables)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def host_us(fn, reps=20):
    """Median host microseconds of one call of ``fn()``, the card idle when
    it starts: what issuing it costs the frame's thread."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _rope_model_check(h=288, w=512):
    """ViT-L's encode and one pair decode under a profiler: every attention
    launches the RoPE kernel once, and ``model.rope_launches`` counts it."""
    from torch.profiler import ProfilerActivity, profile

    from frodo_slam_tpu_torch.utils import spans

    model = mast3r.init_model(mast3r.MASt3RConfig(), seed=0, device=DEV)
    img = torch.randn((1, h, w, 3), device=DEV)
    mast3r.encode_image(model, img)  # warm
    zero_counts()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        feat, pos = mast3r.encode_image(model, img)
        enc = read_counts()
        mast3r.decode_and_heads(model, feat, pos, feat, pos, (h, w))
    torch.cuda.synchronize()
    dec = {k: v - enc[k] for k, v in read_counts().items()}
    counted = {r["name"]: r["counters"].get("model.rope_launches") for r in spans.records()}
    spans.clear()
    out = dict(encode=[enc["rope2d"], enc["flash_attention"]], decode=[dec["rope2d"], dec["flash_attention"]],
               counter=counted)
    del model
    torch.cuda.empty_cache()
    assert out["encode"] == [24, 24] and out["decode"] == [48, 48], out
    assert counted == {"model.encode": 24, "model.decode": 48}, counted
    return out


def phase_rope():
    rope = rope_kernel.rope2d_
    out = []
    for i, (B, H, Nq, Nk, D, dt, layout) in enumerate(ROPE_SHAPES):
        q, k, tq, tk = kernel_cases.rope_case(B, H, Nq, Nk, D, dt, layout, 200 + i, DEV)
        if layout == "qkv":
            Nk = Nq
        want_q, want_k = rope_kernel.rope2d_plain(q, tq), rope_kernel.rope2d_plain(k, tk)
        before = rope.launches
        rope(q, k, tq, tk)
        torch.cuda.synchronize()
        assert rope.launches == before + 1
        equal = bool(torch.equal(q, want_q)) and bool(torch.equal(k, want_k))
        pos_q = kernel_cases.rope_pos(B, Nq, DEV)
        pos_k = kernel_cases.rope_pos(B, Nk, DEV)
        plain = lambda: (rope_kernel.rope2d_plain(q, tq), rope_kernel.rope2d_plain(k, tk))  # noqa: E731
        per_call = lambda: (layers_mod.apply_rope2d(q, pos_q), layers_mod.apply_rope2d(k, pos_k))  # noqa: E731
        kernel = lambda: rope(q, k, tq, tk)  # noqa: E731
        bound_ms, nbytes = rope_bound(B, H, Nq, Nk, D, dt, layout)
        r = dict(shape=[B, H, Nq, Nk, D], dtype=str(dt).split(".")[-1], layout=layout, equal=equal,
                 # per call ~70 launches: 10 calls stay inside the queue the spin kernel fills
                 ms=cuda_ms_queued(kernel), plain_ms=cuda_ms_queued(plain),
                 per_call_ms=cuda_ms_queued(per_call, reps=10),
                 host_us=host_us(kernel), per_call_host_us=host_us(per_call),
                 attention_host_us=host_us(lambda: attention_kernel.flash_attention(q, k, k)),
                 bound_ms=bound_ms, bound_by="bytes", bytes=nbytes)
        emit("rope", **r)
        out.append(r)
        if not equal:
            raise AssertionError(f"RoPE kernel != plain twin at {r['shape']} {r['dtype']} {layout}")
        del q, k, tq, tk, want_q, want_k
    pos = kernel_cases.rope_pos(1, 768, DEV)
    tables = lambda: layers_mod.rope_tables(pos, 64, 100.0, torch.bfloat16)  # noqa: E731
    emit("rope_tables", tokens=768, ms=cuda_ms_queued(tables), host_us=host_us(tables))
    model = _rope_model_check()
    emit("rope_model", **model)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# resample: a frame's resize, crop and ImgNorm on the card vs the host path
# ---------------------------------------------------------------------------

def resample_bound(h, w, oh, ow):
    """Least time for one frame: the f32 frame read once and the f32 network
    input written once, over the memory rate."""
    nbytes = 4 * 3 * (h * w + oh * ow)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def phase_resample():
    from frodo_slam_tpu_torch.slam.system import preprocess_image, preprocess_to_device

    fn = resample_kernel.resample
    cpu = torch.device("cpu")
    out = []
    for i, (h, w) in enumerate(kernel_cases.RESAMPLE_SHAPES):
        oh, ow = resample_kernel.plan((h, w), 512).out_hw
        equal = {}
        for kind in kernel_cases.RESAMPLE_KINDS:
            frame = kernel_cases.resample_frame(h, w, kind, 300 + i, cpu).numpy()
            want = preprocess_image(frame, (oh, ow), False)
            before = fn.launches
            got = preprocess_to_device(frame, (oh, ow), False, DEV)
            torch.cuda.synchronize()
            assert fn.launches == before + 2, fn.launches - before
            equal[kind] = got.shape == want.shape and np.array_equal(
                got.cpu().numpy().view(np.uint32), np.ascontiguousarray(want, np.float32).view(np.uint32))
        frame = kernel_cases.resample_frame(h, w, "random", 300 + i, cpu).numpy()
        dev_frame = torch.from_numpy(frame).to(DEV)
        kernel = lambda: resample_kernel.resize_normalize(dev_frame, 512)  # noqa: E731
        plain = lambda: resample_kernel.resize_normalize_plain(dev_frame, resample_kernel.plan((h, w), 512))  # noqa: E731
        bound_ms, nbytes = resample_bound(h, w, oh, ow)
        r = dict(shape=[h, w], out=[oh, ow], equal=equal, ms=cuda_ms_queued(kernel), host_us=host_us(kernel),
                 plain_ms=cuda_ms_queued(plain, reps=10),
                 call_host_ms=host_us(lambda: preprocess_to_device(frame, (oh, ow), False, DEV)) / 1e3,
                 host_path_ms=host_us(lambda: preprocess_image(frame, (oh, ow), False), reps=10) / 1e3,
                 bound_ms=bound_ms, bound_by="bytes", bytes=nbytes)
        emit("resample", **r)
        out.append(r)
        if not all(equal.values()):
            raise AssertionError(f"resample kernel != host path at {h}x{w}: {equal}")
        del dev_frame
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
    assert launches["rope2d"] == launches["flash_attention"], f"RoPE not once an attention: {launches}"
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


# ---------------------------------------------------------------------------
# calib: the calibrated edge kernel at the tum cells' window shapes
# ---------------------------------------------------------------------------

CALIB_KW = dict(sigma_pixel=1.0, sigma_depth=10.0, pixel_border=-10.0, depth_eps=1e-6)


def calib_bound(A, D, E, N, P, itemsize=4):
    """Least time for one call, for the work these inputs need: each live
    row's z_i, w0 (scalars) and idx (int32) read once, each distinct frame
    its live rows read once (3 scalars a point), the P poses (8) read and
    every row's B and g written (56), vs A x N x FLOPS_PER_POINT operations
    at the f32 (or f64) peak outside the tensor cores."""
    nbytes = A * N * (2 * itemsize + 4) + D * N * 3 * itemsize + (P * 8 + E * 56) * itemsize
    ops = A * N * calib_edge_kernel.FLOPS_PER_POINT
    peak = F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _calib_cell_rate(seed=2147520001, seconds=5.0):
    """A traced run of the cell ``tum384.kf-every`` (slambench, on this
    card): each calibrated window solve's ``backend.calib_launches`` over
    its ``backend.solve_iters``, summed over the traced session."""
    from slambench import run as bench_run

    from frodo_slam_tpu_torch.utils import spans

    spans.clear()
    before = calib_edge_kernel.calib_edge_systems.launches
    c = bench_run.load_cell("tum384.kf-every")
    r = bench_run.run_cell(c, seed, seconds, True, "cuda", time.time())
    solves = [x for x in spans.records() if x["name"] == "backend.solve_calib"]
    total = lambda name: sum(x["counters"].get(name, 0) for x in solves)  # noqa: E731
    iters, launches = total("backend.solve_iters"), total("backend.calib_launches")
    replays, captures = total("backend.step_replays"), total("backend.step_captures")
    spans.clear()
    torch.cuda.empty_cache()
    return dict(seed=seed, correct=bool(bench_run.judge(r["checks"], c["limits"])[0]), solves=len(solves),
                solve_iters=iters, calib_launches=launches, rate=launches / iters if iters else None,
                iters_per_solve=iters / len(solves) if solves else None,
                run_launches=calib_edge_kernel.calib_edge_systems.launches - before,
                step_replays=replays, step_captures=captures, step_rate=replays / iters if iters else None)


def phase_calib():
    """Each case of kernel_cases.CALIB_CASES at 384x512 (the window buckets
    of a 32-frame session, N = 196,608): f32 and f64 kernel vs the f64 plain
    version (f32 within 1e-4 of each live edge's largest entry, f64 within
    1e-9), inactive rows exactly 0, two calls bitwise equal, one launch a
    call; the device time (calls queued behind a spin kernel), the
    single-call time, the f64 device time and the f32 plain twin's time on
    the card beside the bound. Then a traced run of tum384.kf-every: one
    kernel launch a GN iteration (``backend.calib_launches`` over
    ``backend.solve_iters``)."""
    ck = calib_edge_kernel
    hw = kernel_cases.CALIB_HW
    per_case = {}
    for k, case in enumerate(kernel_cases.CALIB_CASES):
        args = kernel_cases.calib_case(case, 400 + k, DEV)
        E, A, P = kernel_cases.CALIB_CASES[case]
        jj, active = args[6], args[8]
        _, D = kernel_cases.ray_counts(jj, active)
        N = int(args[2].shape[2])
        kw = dict(img_hw=hw, **CALIB_KW)
        run32 = lambda: ck.calib_edge_systems(*args, **kw, n_active=A)  # noqa: E731
        d64 = tuple(a.double() if a.is_floating_point() else a for a in args)
        run64 = lambda: ck.calib_edge_systems(*d64, **kw, n_active=A)  # noqa: E731
        before = ck.calib_edge_systems.launches
        (B32, g32), (B32b, g32b), (B64, g64), (B64b, g64b) = run32(), run32(), run64(), run64()
        torch.cuda.synchronize()
        launched = ck.calib_edge_systems.launches - before
        Bp, gp = ck.calib_edge_systems_plain(*d64, **kw)
        live = active.cpu()
        dead = ~active
        out = dict(case=case, E=E, N=N, A=A, D=D, P=P, launches=launched,
                   err_f32=max(_rel_err(B32, Bp, live), _rel_err(g32, gp, live)),
                   err_f64=max(_rel_err(B64, Bp, live), _rel_err(g64, gp, live)),
                   repeatable=bool(torch.equal(B32, B32b) and torch.equal(g32, g32b)
                                   and torch.equal(B64, B64b) and torch.equal(g64, g64b)),
                   inactive_zero=bool(all(int(torch.count_nonzero(t[dead])) == 0
                                          for t in (B32, g32, B64, g64))))
        del Bp, gp
        out["device_ms"] = cuda_ms_queued(run32)
        out["single_ms"] = cuda_ms(run32)
        out["host_us"] = host_us(run32)
        out["f64_device_ms"] = cuda_ms_queued(run64)
        out["plain_ms"] = cuda_ms(lambda: ck.calib_edge_systems_plain(*args, **kw), reps=3, warmup=1)
        out["f64_bound_ms"] = calib_bound(A, D, E, N, P, 8)["bound_ms"]
        out.update(calib_bound(A, D, E, N, P))
        per_case[case] = out
        emit("calib", **out)
        if not (out["err_f32"] <= 1e-4 and out["err_f64"] <= 1e-9):
            raise AssertionError(f"calib kernel disagrees with its plain version on {case}")
        if not (out["repeatable"] and out["inactive_zero"] and launched == 4):
            raise AssertionError(f"calib kernel not repeatable, an inactive row not 0 or launches "
                                 f"{launched} != 4 on {case}")
        del args, d64, B32, g32, B32b, g32b, B64, g64, B64b, g64b
        torch.cuda.empty_cache()
    cell = _calib_cell_rate()
    emit("calib_cell", **cell)
    if not (cell["solves"] and cell["rate"] == 1.0 and cell["correct"]):
        raise AssertionError(f"tum384.kf-every: the calibrated solve did not launch the kernel once a "
                             f"GN iteration: {cell}")
    if not (cell["step_rate"] >= 0.95 and cell["step_captures"] == 0):
        raise AssertionError(f"tum384.kf-every: the timed session's GN steps are not graph replays, "
                             f"or it captured: {cell}")
    per_case["cell"] = cell
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
    """Five identical frames through the calibrated tracker under a
    profiler; each new keyframe's task runs the calibrated window solve.
    Returns the flags, the keyframe poses, the solves and each solve's
    (``backend.solve_iters``, ``backend.calib_launches``)."""
    from torch.profiler import ProfilerActivity, profile

    from frodo_slam_tpu_torch.utils import spans

    model = _tiny_model(device)
    h, w = 32, 64
    img = np.random.default_rng(2).uniform(0, 1, (h, w, 3)).astype(np.float32)
    slam = SLAM(_backend_cfg(use_calib=True, max_keyframes=8, max_edges=8, max_odom_edges=8), model,
                (h, w), calib=TINY_K, use_backend=True, single_thread=True, device=device)
    solves = []
    real = slam.backend.solve_window
    slam.backend.solve_window = lambda *a, **k: solves.append(1) or real(*a, **k)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        flags = [slam.grab_rgb(img, timestamp=float(i))[::2] for i in range(5)]
    counted = [(x["counters"].get("backend.solve_iters"), x["counters"].get("backend.calib_launches"))
               for x in spans.records() if x["name"] == "backend.solve_calib"]
    spans.clear()
    poses = slam.keyframe_poses()[1]
    slam.terminate()
    return flags, poses, len(solves), counted


def phase_calib_tiny():
    before = read_counts()
    fl_g, P_g, solves_g, counted_g = _tiny_calib(DEV)
    launched = {k: v - before[k] for k, v in read_counts().items()}
    fl_c, P_c, solves_c, counted_c = _tiny_calib(torch.device("cpu"))
    diff = float(np.abs(P_g - P_c).max())
    iters = sum(n for n, _ in counted_g)
    emit("calib_tiny", flags_cuda=fl_g, flags_cpu=fl_c, calib_solves=solves_g,
         pose_max_abs_diff=diff, launches=launched, solve_iters=[n for n, _ in counted_g],
         calib_launches=[m for _, m in counted_g], rate=sum(m for _, m in counted_g) / iters if iters else None,
         cpu_calib_launches=[m for _, m in counted_c])
    assert fl_g == fl_c and all(f == (True, True) for f in fl_g)
    assert solves_g == solves_c == 4 and np.isfinite(P_g).all()
    assert len(counted_g) == 4 and all(m == n for n, m in counted_g), counted_g
    assert launched["calib_edge_systems"] == iters and all(m == 0 for _, m in counted_c), counted_c
    assert launched["ray_edge_systems"] == 0, "the calibrated solve launched the ray kernel"
    assert launched["refine_matches"] > 0 and launched["flash_attention"] > 0, launched
    np.testing.assert_allclose(P_g, P_c, atol=1e-4)


# the VIO mode at tiny_config: every frame a keyframe, odometry moving 1 cm a
# frame (the frames stay identical), the tracking GN run to its fixed point
# (with the default stopping rule the two devices may stop an iteration
# apart), the height prior on
VIO_TINY_CFG = dict(
    tracking={**FORCE_KEYFRAMES["tracking"], "max_iters": 30, "rel_error": 1e-9, "delta_norm": 1e-9},
    local_opt={**FORCE_KEYFRAMES["local_opt"], "max_iters": 2},
    height_prior={"enabled": True, "ransac_iters": 50},
    tpu={"max_keyframes": 16, "max_edges": 16, "max_odom_edges": 16})


def _vio_odom(i, step=0.01):
    return np.array([step * i, 0.2 * step * i, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32)


def _tiny_vio(device, work):
    """Twelve identical frames through SLAM(local_opt_mode=True) (the PGO
    goes live at the eleventh keyframe), then one window solve with explicit
    live scale targets, then a checkpoint round trip on ``device``."""
    from frodo_slam_tpu_torch.utils.checkpoint import load_slam_state, save_slam_state

    model = _tiny_model(device)
    h, w = 32, 64
    img = np.random.default_rng(2).uniform(0, 1, (h, w, 3)).astype(np.float32)
    build = lambda: SLAM(make_config(**VIO_TINY_CFG), model, (h, w), use_backend=True,  # noqa: E731
                         single_thread=True, local_opt_mode=True, device=device)
    slam = build()
    flags = [slam.grab_rgb(img, timestamp=float(i), odom_pose=_vio_odom(i))[::2] for i in range(12)]
    poses = slam.keyframe_poses()[1]
    s = float(slam.pgo.scale[0, 0])
    # the PGO solve alone: this device's ring solved again on the CPU
    from frodo_slam_tpu_torch.slam import pgo as pgo_mod

    ring = dataclasses.replace(slam.pgo, **{f: getattr(slam.pgo, f).cpu() for f in ("Twc", "Todom", "scale")})
    s_ring = float(pgo_mod.pgo_optimize(ring)[1])
    n = slam.store.n_size
    s_bar = np.where(np.arange(n) % 2 == 1, 0.8, -1.0).astype(np.float32)  # every other target live
    uniq, p, T_new = slam.backend.solve_window(slam.store, s_bar)
    extra = T_new[:p].cpu().numpy()
    ckpt = save_slam_state(slam, str(work / f"vio_tiny_{device.type}.npz"))
    back = build()
    load_slam_state(back, ckpt)
    same = (all(torch.equal(getattr(back.store, f), getattr(slam.store, f))
                for f in ("T_WC", "X_canon", "C", "feat", "N", "N_updates"))
            and all(torch.equal(a, b) for a, b in zip(back.backend.edges + back.backend.odom,
                                                      slam.backend.edges + slam.backend.odom))
            and all(torch.equal(getattr(back.pgo, f), getattr(slam.pgo, f)) for f in ("Twc", "Todom", "scale"))
            and back.backend._pairs == slam.backend._pairs and back.pgo.n_total == slam.pgo.n_total)
    resumed = back.grab_rgb(img, timestamp=12.0, odom_pose=_vio_odom(12))
    slam.terminate()
    back.terminate()
    return dict(flags=flags, poses=poses, s=s, s_ring=s_ring, extra=extra, uniq=uniq[:p], roundtrip=same,
                resumed_ok=bool(resumed[0]) and bool(np.isfinite(resumed[1]).all()),
                fits=len(slam._hp_cache))


def phase_vio_tiny(work=None):
    """The VIO mode (odometry factors, scale-only PGO, height prior) at
    tiny_config on the card against the same on the CPU; an explicit
    scale-target solve; a checkpoint round trip on the card. The PGO's
    solve on the card is held within 1e-6 of the same ring solved on the
    CPU; the scale each device's run ends with within 1e-4 relative, the
    relative bar of the poses: it is a ratio of the VO deltas the poses
    carry, and those differ by the f32 ray sums of the window solves
    (~2e-6 a solve)."""
    work = pathlib.Path(work or ROOT / "build" / "chip_smoke")
    work.mkdir(parents=True, exist_ok=True)
    before = read_counts()
    g = _tiny_vio(DEV, work)
    launched = {k: v - before[k] for k, v in read_counts().items()}
    c = _tiny_vio(torch.device("cpu"), work)
    r = dict(flags_cuda=g["flags"], flags_cpu=c["flags"], pgo_s_cuda=g["s"], pgo_s_cpu=c["s"],
             pgo_s_cuda_ring_on_cpu=g["s_ring"],
             pose_max_abs_diff=float(np.abs(g["poses"] - c["poses"]).max()),
             scale_max_abs_diff=float(np.abs(g["poses"][:, 7] - c["poses"][:, 7]).max()),
             extra_solve_max_abs_diff=float(np.abs(g["extra"] - c["extra"]).max()),
             checkpoint_roundtrip_cuda=g["roundtrip"], resumed_ok=g["resumed_ok"], plane_fits=g["fits"],
             launches=launched)
    emit("vio_tiny", **r)
    assert g["flags"] == c["flags"] and all(f == (True, True) for f in g["flags"]), (g["flags"], c["flags"])
    assert g["s"] != 1.0, "the PGO never went live"
    np.testing.assert_allclose(g["s"], g["s_ring"], rtol=1e-6)
    np.testing.assert_allclose(g["s"], c["s"], rtol=1e-4)
    assert np.isfinite(g["poses"]).all() and np.abs(g["poses"][1:, 7] - 1.0).max() > 1e-3
    np.testing.assert_allclose(g["poses"], c["poses"], atol=1e-4)
    assert g["uniq"] == c["uniq"]
    np.testing.assert_allclose(g["extra"], c["extra"], atol=1e-4)
    assert g["roundtrip"] and c["roundtrip"] and g["resumed_ok"]
    assert launched["ray_edge_systems"] > 0 and launched["refine_matches"] > 0, launched
    return r


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
            # a solve ends in its last iteration's host fetch, so its wall
            # time holds its device work (and what the frontend queued on
            # the shared stream meanwhile)
            r = dict(stage=stage, wall_ms=(time.perf_counter() - t0) * 1e3)
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
    be.solve_window = wrap("solve", be.solve_window)


# the GN step as a CUDA graph against the eager chain on one window, relative
# to the largest pose entry (tests/test_torch_solve_graph.py's bars)
GRAPH_SOLVE_BAR = {True: 1e-10, False: 1e-5}  # by BAConfig.solve_f64


def _solve_steps(records) -> dict:
    """Each solve's GN iterations, step replays and captures (its
    ``last_solve``) as lists, with their sums."""
    out = {k: [r.get(k, 0) for r in records] for k in ("iters", "step_replays", "step_captures")}
    out["totals"] = {k: sum(v) for k, v in out.items()}
    return out


def _graph_vs_eager(be, store, cfg=None, seed=4):
    """One window of the backend ``be`` over ``store``, its odometry rows
    dropped (they keep the eager chain) and its poses perturbed so that it
    iterates, solved on the card twice with the GN step graphed (the second
    at a cached shape: a replay an iteration, no capture) and once eagerly
    (``global_opt._graphs_engage`` off). ``cfg``: the solve's BAConfig (the
    backend's by default). Returns the three solves' iterations, replays and
    captures and the largest pose difference, over the largest pose entry,
    of each graphed solve from the eager one."""
    cfg = cfg or be.cfg
    uniq, p, T_win, X_win, C_win, edges_win, odom_win, sb = be._build_window(store, None)
    if be.K is not None:
        X_win = constrain_points_to_ray(be.img_hw, X_win, be.K)
    noise = torch.from_numpy(np.random.default_rng(seed).normal(size=(T_win.shape[0], 7)) * 0.01)
    noise[:cfg.pin] = 0.0
    T0 = lie.sim3_retr(T_win, noise.to(T_win))
    no_odom = global_opt.empty_odom_edges(0, device=T_win.device)

    def run():
        st = {}
        kw = dict(stats=st, n_active=2 * len(be._pairs))
        if be.K is None:
            T = global_opt.solve_gn_rays(cfg, cfg.pin, T0, X_win, C_win, edges_win, no_odom, sb, **kw)
        else:
            T = global_opt.solve_gn_calib(cfg, cfg.pin, be.img_hw, T0, X_win, C_win, be.K, edges_win,
                                          no_odom, sb, **kw)
        torch.cuda.synchronize()
        return T, st

    g1, st1 = run()
    g2, st2 = run()
    real = global_opt._graphs_engage
    global_opt._graphs_engage = lambda *a: False
    try:
        e, st_e = run()
    finally:
        global_opt._graphs_engage = real
    scale = float(e.abs().max())
    out = dict(window_poses=int(T_win.shape[0]), window_rows=int(edges_win.ii.shape[0]),
               odom_rows_dropped=int(odom_win.ii.shape[0]), solve_f64=cfg.solve_f64,
               graphed_first=st1, graphed_again=st2, eager=st_e,
               pose_rel_diff=[float((g - e).abs().max()) / scale for g in (g1, g2)],
               bar=GRAPH_SOLVE_BAR[cfg.solve_f64])
    if not (st1["iters"] == st2["iters"] == st_e["iters"] >= 2 and st2["step_replays"] == st2["iters"]
            and st2["step_captures"] == 0 and st_e["step_replays"] == 0
            and max(out["pose_rel_diff"]) <= out["bar"]):
        raise AssertionError(f"the graphed window solve is off the eager one: {out}")
    return out


def _backend_run(model, frames, single_thread, extra_pairs, placement=None, phase="backend_main",
                 x64_eval=None, keep=False):
    """``extra_pairs`` (0, 2 or 3): after the run, one add_factors of that
    many pairs with the newest keyframe (n-2: consecutive, 2 and 0: loop
    closures) and a window solve. Each solve launches the ray kernel once a
    GN iteration and edge part. ``x64_eval``: ``tpu.x64_eval`` of the run's
    config (None: absent, the f64 solve). ``keep``: the result carries the
    terminated SLAM under ``"slam"``."""
    failures = _Failures()
    logging.getLogger("frodo_slam_tpu_torch").addHandler(failures)
    tpu = {} if x64_eval is None else {"x64_eval": x64_eval}
    slam = SLAM(_backend_cfg(**tpu), model, frames[0].shape[:2], use_backend=True,
                single_thread=single_thread, placement=placement)
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
        ii = [n - 2, 2, 0][:extra_pairs]
        slam.backend.add_factors(slam.store, ii, [n - 1] * len(ii))
        slam.backend.solve_GN(slam.store)
    torch.cuda.synchronize()
    launches = read_counts()
    logging.getLogger("frodo_slam_tpu_torch").removeHandler(failures)
    poses = slam.keyframe_poses()[1]
    solves = [r for r in rec if r["stage"] == "solve"]
    parts = [1 if placement is None else len(mesh.edge_parts(r["edge_rows"], placement)) for r in solves]
    out = dict(single_thread=single_thread, frames=len(frames), run_s=run_s,
               frame_ms=[round(x, 3) for x in ms], median_frame_ms_after_first=statistics.median(ms[1:]),
               decode_match_ms=[round(r["ms"], 3) for r in rec
                                if r["stage"] == "decode_match" and "ms" in r],
               solve_ms=[round(r["ms"], 3) for r in solves if "ms" in r],
               solve_wall_ms=[round(r["wall_ms"], 3) for r in solves], solve_f64=slam.ba_cfg.solve_f64,
               gn_iters=[r["iters"] for r in solves], ray_launches_per_solve=[r["ray_launches"] for r in solves],
               edge_rows=[r["edge_rows"] for r in solves], window_poses=[r["poses"] for r in solves],
               pairs=len(slam.backend._pairs), n_odom=slam.backend._n_odom, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(), allocated_at_start=at_start,
               joined=joined, edge_parts_per_solve=parts, steps=_solve_steps(solves),
               backend_task_failures=failures.records, extra_pairs=extra_pairs,
               ok_new_kf=[sum(f[0] for f in flags), sum(f[1] for f in flags)],
               poses=poses.tolist(), pair_list=[list(q) for q in slam.backend._pairs])
    if placement is not None:
        out.update(dp=placement.dp, tp=placement.tp, slots=list(placement.backend_slots),
                   note="aliases of one card: not a multi-card speed")
    emit(phase, **{k: v for k, v in out.items() if k not in ("poses", "pair_list")})
    assert not failures.records, f"backend tasks failed: {failures.records}"
    assert joined, "the threaded backend did not join"
    assert all(f == (True, True) for f in flags), flags
    assert np.isfinite(poses).all() and poses.shape == (len(frames), 8)
    assert launches["ray_edge_systems"] > 0, "the backend never launched the ray kernel"
    assert launches["refine_matches"] > 0, "the backend path never launched the refine kernel"
    assert launches["flash_attention"] > 0, "the backend path never launched the attention kernel"
    assert launches["ray_edge_systems"] == sum(out["ray_launches_per_solve"])
    assert out["ray_launches_per_solve"] == [i * k for i, k in zip(out["gn_iters"], parts)]
    assert len(solves) == len(frames) - 1 + int(extra_pairs > 0)
    if keep:
        out["slam"] = slam
    return out


def phase_backend_main(n_frames=12, hw=(288, 512), model_cfg=None):
    h, w = hw
    model = mast3r.init_model(model_cfg or mast3r.MASt3RConfig(), seed=0, device=DEV)
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    frames = smooth_random_frames(1, h, w, seed=3) * n_frames
    ser = _backend_run(model, frames, single_thread=True, extra_pairs=2, keep=True)
    slam = ser.pop("slam")
    emit("backend_main_graph", **_graph_vs_eager(slam.backend, slam.store))
    del slam
    thr = _backend_run(model, frames, single_thread=False, extra_pairs=0)
    torch.cuda.empty_cache()
    return ser, thr


# ---------------------------------------------------------------------------
# placement_main: the multi-card placement on aliases of one card
# ---------------------------------------------------------------------------

# split decode vs unsplit, per output relative to max(1, its largest
# magnitude): bf16 partial sums round at other places. The CPU test
# (tests/test_torch_placement.py::test_tp_split_decode_bf16_bar, tiny width)
# measures at most 0.041, and the split at most 1.7x as far from the f32
# decode as the unsplit bf16 decode is
SPLIT_DECODE_BAR = 0.1
SPLIT_DECODE_F32_RATIO = 2.0
# a window solve split vs unsplit on the same edges (f32 systems, f64 solve)
SPLIT_SOLVE_BAR = 1e-5
# whole runs, placed vs unplaced, on identical frames: the runs read 4.4e-6
# and 4.1e-6 (NVIDIA H100 80GB HBM3, 700.00 W). On identical frames the
# window poses stay near identity whatever the decode gives, so this holds
# the plumbing (keyframes, pairs, joining, results moved back); the fixed
# pair batch's decode bars and SPLIT_SOLVE_BAR hold the split's arithmetic
PLACED_POSE_BAR = 1e-4


def _describe(pl):
    return None if pl is None else dict(dp=pl.dp, tp=pl.tp,
                                        backend_slots=list(pl.backend_slots),
                                        devices=[str(d) for d in pl.devices])


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1.0))


class _AttnShapes:
    """Counts the attention calls of the model's layers by (B, H, N, D)
    while installed (it calls the counted wrapper)."""

    def __init__(self):
        self.shapes = {}
        self.real = layers_mod.flash_attention

    def __call__(self, q, k, v):
        key = "x".join(map(str, q.shape))
        self.shapes[key] = self.shapes.get(key, 0) + 1
        return self.real(q, k, v)

    def __enter__(self):
        layers_mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        layers_mod.flash_attention = self.real


def phase_placement_main(n_frames=12, hw=(288, 512)):
    """The backend split over a (dp, tp) grid of aliases of cuda:0 at ViT-L
    width: shared as dp 2 x tp 2 over four aliases (serialized), overlap as
    the tracker on slot 0 and dp 2 x tp 1 on slots 1-2 (threaded), each held
    against the unplaced serialized run of the same frames."""
    n_dev = torch.cuda.device_count()
    emit("placement_devices", count=n_dev, overlap=_describe(mesh.default_placement("overlap")),
         shared=_describe(mesh.default_placement("shared")))
    h, w = hw
    model = mast3r.init_model(mast3r.MASt3RConfig(), seed=0, device=DEV)
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    frames = smooth_random_frames(1, h, w, seed=3) * n_frames
    shared = mesh.make_placement(2, 2, [DEV] * 4)
    overlap = mesh.make_placement(2, 1, [DEV] * 3, first_slot=1)

    # one fixed pair batch: the split decode vs the unsplit one and the f32 one
    imgs = torch.from_numpy(np.stack(smooth_random_frames(2, h, w, seed=5)) * 2.0 - 1.0).float().to(DEV)
    feat, pos = mast3r.encode_image(model, imgs)
    fi, fj, pp = feat, feat.flip(0), pos
    t0 = time.perf_counter()
    reps = mesh.backend_replicas(model, shared)
    torch.cuda.synchronize()
    replica_s = time.perf_counter() - t0
    with torch.device(DEV):
        m32 = mast3r.MASt3R(dataclasses.replace(model.cfg, dtype=torch.float32)).eval()
    m32.load_state_dict(model.state_dict())
    m32.cast_transformer_()
    with _AttnShapes() as shapes:
        S = decode_symmetric_split(reps, shared, fi, pp, fj, pp, hw)
    U = decode_symmetric_batch(model, fi, pp, fj, pp, hw)
    F = decode_symmetric_batch(m32, fi, pp, fj, pp, hw)
    torch.cuda.synchronize()
    dec = {k: dict(split_vs_bf16=_rel(a, b), split_vs_f32=_rel(a, c), bf16_vs_f32=_rel(b, c))
           for k, a, b, c in zip(("pts3d", "conf", "desc", "desc_conf"), S, U, F)}
    emit("placement_decode", replica_build_s=round(replica_s, 3), pairs=2, grid=[2, 2], errors=dec,
         attention_shapes=shapes.shapes, bar=SPLIT_DECODE_BAR, f32_ratio=SPLIT_DECODE_F32_RATIO)
    for k, e in dec.items():
        if not (e["split_vs_bf16"] <= SPLIT_DECODE_BAR
                and e["split_vs_f32"] <= SPLIT_DECODE_F32_RATIO * max(e["bf16_vs_f32"], 1e-3)):
            raise AssertionError(f"split decode off the unsplit one on {k}: {e}")
    cfg = model.cfg
    shard = lambda b: f"{b}x{cfg.dec_num_heads // 2}x{(h // 16) * (w // 16)}x{cfg.dec_embed_dim // cfg.dec_num_heads}"  # noqa: E731
    assert shapes.shapes.get(shard(2), 0) > 0, shapes.shapes  # ViT-L: 2x6x576x64
    del reps, m32, S, U, F

    # the runs: unplaced serialized, shared serialized, overlap threaded
    runs = {}
    with _AttnShapes() as shapes:
        runs["unplaced"] = _backend_run(model, frames, True, 3, phase="placement_unplaced")
        base = dict(shapes.shapes)
        unplaced = dict(base)
        runs["shared"] = _backend_run(model, frames, True, 3, placement=shared, phase="placement_shared")
        placed = {k: v - base.get(k, 0) for k, v in shapes.shapes.items() if v > base.get(k, 0)}
        base = dict(shapes.shapes)
        runs["overlap"] = _backend_run(model, frames, False, 3, placement=overlap, phase="placement_overlap")
        placed_ov = {k: v - base.get(k, 0) for k, v in shapes.shapes.items() if v > base.get(k, 0)}
    ref = np.asarray(runs["unplaced"]["poses"])
    diffs = {}
    for name in ("shared", "overlap"):
        r = runs[name]
        assert r["pair_list"] == runs["unplaced"]["pair_list"], (name, r["pair_list"])
        diffs[name] = float(np.abs(np.asarray(r["poses"]) - ref).max())

    # one window solve on identical edges, split vs unsplit (poses perturbed
    # off the identical frames' identity, so that the solve iterates)
    slam = SLAM(_backend_cfg(), model, hw, use_backend=True, single_thread=True, placement=shared)
    for i, img in enumerate(frames[:8]):
        slam.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))
    be = slam.backend
    uniq, p, T_win, X_win, C_win, edges_win, odom_win, sb = be._build_window(slam.store, None)
    noise = torch.from_numpy(np.random.default_rng(4).normal(size=(T_win.shape[0], 7)) * 0.01).float()
    noise[:1] = 0.0
    T0 = lie.sim3_retr(T_win, noise.to(DEV))
    solved, iters = {}, {}
    for name, pl in (("split", shared), ("unsplit", None)):
        st = {}
        l0 = ba_reduce_kernel.ray_edge_systems.launches
        solved[name] = global_opt.solve_gn_rays(be.cfg, be.cfg.pin, T0, X_win, C_win, edges_win, odom_win, sb,
                                                stats=st, n_active=2 * len(be._pairs), placement=pl)
        iters[name] = (st["iters"], ba_reduce_kernel.ray_edge_systems.launches - l0)
    slam.terminate()
    solve_diff = float((solved["split"] - solved["unsplit"]).abs().max())
    E = int(edges_win.ii.shape[0])
    out = dict(pose_max_abs_diff=diffs, pose_bar=PLACED_POSE_BAR, solve_max_abs_diff=solve_diff,
               solve_bar=SPLIT_SOLVE_BAR, solve_rows=E, solve_parts=len(mesh.edge_parts(E, shared)),
               solve_iters_launches=iters, attention_shapes_unplaced=unplaced, attention_shapes_shared=placed, attention_shapes_overlap=placed_ov,
               frame_ms={k: r["median_frame_ms_after_first"] for k, r in runs.items()},
               task_ms={k: r["decode_match_ms"] for k, r in runs.items() if r["decode_match_ms"]},
               solve_ms={k: r["solve_ms"] for k, r in runs.items() if r["solve_ms"]},
               max_memory_allocated={k: r["max_memory_allocated"] for k, r in runs.items()},
               launches={k: r["launches"] for k, r in runs.items()},
               note="aliases of one card: every split runs at its shapes, no multi-card speed")
    emit("placement_main", **out)
    assert all(d <= PLACED_POSE_BAR for d in diffs.values()), diffs
    assert solve_diff <= SPLIT_SOLVE_BAR, solve_diff
    assert iters["split"][1] == iters["split"][0] * out["solve_parts"] and out["solve_parts"] == 4
    # B = 1: the consecutive pair's missing direction on rank 0; B = 4: the
    # three extra pairs padded to four, two a rank, both directions; each
    # shape is one of ATTN_SHAPES, held against the plain version there
    assert placed.get(shard(1), 0) > 0 and placed.get(shard(4), 0) > 0, placed
    whole = f"4x{cfg.dec_num_heads}x{(h // 16) * (w // 16)}x{cfg.dec_embed_dim // cfg.dec_num_heads}"
    assert placed_ov.get(whole, 0) > 0, placed_ov  # ViT-L: 4x12x576x64
    held = {f"{B}x{H}x{Nq}x{D}" for B, H, Nq, Nk, D, dt in ATTN_SHAPES if Nq == Nk and dt == torch.bfloat16}
    assert set(unplaced) | set(placed) | set(placed_ov) <= held, (unplaced, placed, placed_ov)

    # the per-device shared-memory attribute of the bf16 attention kernel
    if n_dev >= 2:
        d1 = torch.device("cuda", 1)
        q, k, v = kernel_cases.attention_case(1, 6, 576, 576, 64, torch.bfloat16, 7, d1)
        got = attention_kernel.flash_attention(q, k, v)
        torch.cuda.synchronize(d1)
        want = attention_kernel.flash_attention_plain(q, k, v)
        err = float((got.float() - want.float()).abs().max())
        emit("placement_second_card", device=str(d1), max_abs_err=err)
        assert err <= ATTN_BAR[torch.bfloat16] * max(float(want.float().abs().max()), 1.0)
    else:
        print("placement_second_card: not run: one card; the bf16 attention attribute is per device "
              "and only a second card shows it", flush=True)
    torch.cuda.empty_cache()
    return runs, out


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
    rec = dict(frame_ms=[], solve_ms=[], gn_iters=[], edge_rows=[], ray_solves=0, solves=[], last=None)
    real = dict(grab=SLAM.grab_rgb, solve=BackendGraph.solve_window)

    def grab(self, *a, **k):  # ends in the frame's flags fetch: no sync needed
        t = time.perf_counter()
        out = real["grab"](self, *a, **k)
        rec["frame_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def solve(self, *a, **k):
        if self.K is None:
            rec["ray_solves"] += 1
            return real["solve"](self, *a, **k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["solve"](self, *a, **k)
        torch.cuda.synchronize()
        rec["solve_ms"].append((time.perf_counter() - t) * 1e3)
        rec["gn_iters"].append(self.last_solve["iters"] if out is not None else 0)
        rec["edge_rows"].append(self.last_solve["edge_rows"] if out is not None else 0)
        if out is not None:
            rec["solves"].append(dict(self.last_solve))
            rec["last"] = (self, a[0])
        return out

    SLAM.grab_rgb, BackendGraph.solve_window = grab, solve
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
        SLAM.grab_rgb, BackendGraph.solve_window = real["grab"], real["solve"]
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
             ray_solves=rec["ray_solves"], steps=_solve_steps(rec["solves"]),
             max_memory_allocated=torch.cuda.max_memory_allocated(), allocated_at_start=at_start,
             launches=launches, ply_vertices=n_vertex, keyframe_pngs=len(pngs))
    emit("dataset_main", **r)
    r["graph"] = _graph_vs_eager(*rec["last"])
    emit("dataset_main_graph", **r["graph"])
    assert rows.shape == (n_images // 2, 8) and np.isfinite(rows).all(), rows.shape
    assert len(pngs) == rows.shape[0] and n_vertex > 0
    assert len(solve_ms) == rows.shape[0] - 1 and r["ray_solves"] == 0
    assert launches["flash_attention"] > 0 and launches["refine_matches"] > 0, launches
    assert launches["rope2d"] == launches["flash_attention"], f"RoPE not once an attention: {launches}"
    assert launches["ray_edge_systems"] == 0, "the calibrated path launched the ray kernel"
    assert launches["calib_edge_systems"] == sum(rec["gn_iters"]), "not one calibrated launch a GN iteration"
    return r


# ---------------------------------------------------------------------------
# the real-time numerics (tpu.x64_eval: false): realtime.yaml, the backend
# in both numerics, bench_cli.yaml through tools/cli_fps.py
# ---------------------------------------------------------------------------

def _write_identical(folder: pathlib.Path, n: int, h: int, w: int, seed=3):
    """``n`` copies of one smooth random h x w frame as PNGs (random weights
    track identical frames only)."""
    import PIL.Image

    folder.mkdir(parents=True, exist_ok=True)
    img = (smooth_random_frames(1, h, w, seed=seed)[0] * 255).astype(np.uint8)
    for i in range(n):
        PIL.Image.fromarray(img).save(folder / f"{i:05d}.png")


def phase_realtime_main(n_frames=12, work=None):
    """``main.run`` with a config that inherits configs/realtime.yaml (bf16
    heads, ``tpu.x64_eval: false``, the pipelined frontend) and forces every
    tracked frame to a keyframe, on an image folder of 12 identical 288x512
    frames it writes, ViT-L with shared random decoders, --no-retrieval:
    every window solve runs the f32 solve with one refinement step."""
    work = pathlib.Path(work or ROOT / "build" / "chip_smoke") / "realtime"
    seq = work / "seq"
    _write_identical(seq, n_frames, 288, 512)
    cfg = work / "realtime_smoke.yaml"
    cfg.write_text("\n".join([f'inherit: "{ROOT / "configs" / "realtime.yaml"}"']
                             + [f"{k}: {json.dumps(v)}" for k, v in FORCE_KEYFRAMES.items()]) + "\n")
    args = types.SimpleNamespace(dataset=str(seq), config=str(cfg), calib=None, save_as=None, no_viz=True,
                                 viz=False, weights=None, no_retrieval=True, max_frames=None)
    rec = dict(frame_ms=[], solves=[], slam=None)
    real = dict(grab=SLAM.grab_rgb_pipelined, solve=BackendGraph.solve_window)

    def grab(self, *a, **k):  # host time of each call (its flags arrive a frame late)
        rec["slam"] = self
        t = time.perf_counter()
        out = real["grab"](self, *a, **k)
        rec["frame_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def solve(self, *a, **k):
        t = time.perf_counter()
        out = real["solve"](self, *a, **k)  # ends in a host fetch
        rec["solves"].append(dict(wall_ms=(time.perf_counter() - t) * 1e3, solve_f64=self.cfg.solve_f64,
                                  **({} if out is None else self.last_solve)))
        return out

    SLAM.grab_rgb_pipelined, BackendGraph.solve_window = grab, solve
    cwd, env = os.getcwd(), os.environ.get("FRODO_RANDOM_SHARE_DECODER")
    os.environ["FRODO_RANDOM_SHARE_DECODER"] = "1"  # identical frames track (loader.py)
    try:
        os.chdir(work)
        at_start = reset_peak()
        zero_counts()
        t0 = time.perf_counter()
        runner.run(args, device=DEV)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        os.chdir(cwd)
        SLAM.grab_rgb_pipelined, BackendGraph.solve_window = real["grab"], real["solve"]
        if env is None:
            os.environ.pop("FRODO_RANDOM_SHARE_DECODER", None)
        else:
            os.environ["FRODO_RANDOM_SHARE_DECODER"] = env
    slam = rec["slam"]
    poses = slam.keyframe_poses()[1]
    solves = [r for r in rec["solves"] if "iters" in r]
    r = dict(frames=len(rec["frame_ms"]), keyframes=int(slam.store.n_total), run_s=run_s,
             x64_eval=slam.cfg["tpu"]["x64_eval"], solve_f64=slam.ba_cfg.solve_f64,
             head_dtype=str(slam.model_cfg.head_dtype).split(".")[-1],
             pipelined=bool(slam.cfg["tpu"]["pipelined_frontend"]),
             frame_ms=[round(x, 3) for x in rec["frame_ms"]],
             median_frame_ms_after_first=statistics.median(rec["frame_ms"][1:]),
             solve_wall_ms=[round(x["wall_ms"], 3) for x in solves], gn_iters=[x["iters"] for x in solves],
             edge_rows=[x["edge_rows"] for x in solves],
             max_memory_allocated=torch.cuda.max_memory_allocated(), allocated_at_start=at_start,
             launches=launches)
    emit("realtime_main", **r)
    assert r["x64_eval"] is False and not r["solve_f64"] and r["head_dtype"] == "bfloat16" and r["pipelined"]
    assert r["keyframes"] == n_frames and np.isfinite(poses).all() and poses.shape == (n_frames, 8)
    assert len(solves) == n_frames - 1 and not any(x["solve_f64"] for x in solves), rec["solves"]
    for name in PATH_KERNELS:
        assert launches[name] > 0, f"realtime_main never launched {name}: {launches}"
    return r


# one window solved on the card vs on the CPU (kernel vs plain f32 edge
# systems, the card's vs the CPU's factorization). f32 (one refinement
# step): the first card run read 3.9e-6 (NVIDIA H100 80GB HBM3, 700.00 W),
# the bar is about 10x that; f64: the card-vs-CPU bar of the other window
# solves (vio_tiny: atol 1e-4), read 9.8e-7
RT_SOLVE_BAR = {False: 5e-5, True: 1e-4}


def phase_realtime_backend_main(n_frames=12, hw=(288, 512)):
    """backend_main's 12 frames (every frame a keyframe, odometry, ViT-L
    288x512, shared random decoders), threaded, once with ``tpu.x64_eval:
    false`` and once with it true, in one process: solve wall ms, GN
    iterations and ray launches per solve, the largest pose difference
    between the two runs. Then one window of the x64-off run's store, its
    poses perturbed so that the solve iterates, solved on the card and on
    the CPU (plain versions) in each numerics: the two held within
    RT_SOLVE_BAR, the card's solve ms (median of 3, synced) in each."""
    model = mast3r.init_model(mast3r.MASt3RConfig(), seed=0, device=DEV)
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    frames = smooth_random_frames(1, *hw, seed=3) * n_frames
    runs = {}
    for x64 in (False, True):
        runs[x64] = _backend_run(model, frames, single_thread=False, extra_pairs=0, x64_eval=x64,
                                 phase=f"realtime_backend_x64_{'on' if x64 else 'off'}", keep=True)
        assert runs[x64]["solve_f64"] is x64
    between = float(np.abs(np.asarray(runs[False]["poses"]) - np.asarray(runs[True]["poses"])).max())

    slam = runs[False].pop("slam")
    runs[True].pop("slam").terminate()
    be = slam.backend
    graph = {("f64" if f64 else "f32"): _graph_vs_eager(be, slam.store, be.cfg._replace(solve_f64=f64))
             for f64 in (False, True)}
    uniq, p, T_win, X_win, C_win, edges_win, odom_win, sb = be._build_window(slam.store, None)
    noise = torch.from_numpy(np.random.default_rng(4).normal(size=(T_win.shape[0], 7)) * 0.01).float()
    noise[:be.cfg.pin] = 0.0
    T0 = lie.sim3_retr(T_win, noise.to(DEV))
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    win_cpu = (T0.cpu(), X_win.cpu(), C_win.cpu(), type(edges_win)(*map(cpu, edges_win)),
               type(odom_win)(*map(cpu, odom_win)), sb.cpu())
    n_active = 2 * len(be._pairs)
    solve = {}
    for f64 in (False, True):
        cfg = be.cfg._replace(solve_f64=f64)
        st, ms = {}, []
        l0 = ba_reduce_kernel.ray_edge_systems.launches
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = global_opt.solve_gn_rays(cfg, cfg.pin, T0, X_win, C_win, edges_win, odom_win, sb,
                                           stats=st, n_active=n_active)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        launched = (ba_reduce_kernel.ray_edge_systems.launches - l0) // 3
        st_cpu = {}
        want = global_opt.solve_gn_rays(cfg, cfg.pin, *win_cpu[:3], win_cpu[3], win_cpu[4], win_cpu[5],
                                        stats=st_cpu, n_active=n_active)
        solve[f64] = dict(ms=statistics.median(ms), all_ms=[round(x, 3) for x in ms], iters=st["iters"],
                          iters_cpu=st_cpu["iters"], ray_launches=launched,
                          card_vs_cpu=float((got.cpu() - want).abs().max()),
                          step=float((got - T0).abs().max()), bar=RT_SOLVE_BAR[f64], poses=got)
    slam.terminate()
    f32_vs_f64 = float((solve[False]["poses"] - solve[True]["poses"]).abs().max())
    for v in solve.values():
        v.pop("poses")
    out = dict(modes={("x64_on" if k else "x64_off"): dict(
                   solve_wall_ms=r["solve_wall_ms"], gn_iters=r["gn_iters"],
                   ray_launches_per_solve=r["ray_launches_per_solve"], steps=r["steps"],
                   median_frame_ms_after_first=r["median_frame_ms_after_first"], launches=r["launches"])
               for k, r in runs.items()}, graph_vs_eager=graph,
               pose_max_abs_diff_between_modes=between, window_poses=int(T_win.shape[0]),
               window_rows=int(edges_win.ii.shape[0]), live_rows=n_active,
               window_solve={("f64" if k else "f32"): v for k, v in solve.items()},
               window_f32_vs_f64=f32_vs_f64,
               solve_ms_ratio_f64_over_f32=solve[True]["ms"] / solve[False]["ms"])
    emit("realtime_backend_main", **out)
    for f64, v in solve.items():
        if not v["card_vs_cpu"] <= v["bar"]:
            raise AssertionError(f"window solve (f64={f64}) on the card off the CPU's: {v}")
        assert v["ray_launches"] == v["iters"] and v["iters"] >= 2, v
    return runs, out


# counts the kernels the runner's process launches (tools/cli_fps.py runs
# the runner in a child process): the wrappers of WRAPPERS, found by module
# and name, zeroed when the child starts, printed at its end
CLI_FPS_SHIM = """
import importlib, json, runpy, sys
fns = {k: getattr(importlib.import_module(m), a) for k, (m, a) in json.loads(sys.argv[1]).items()}
for f in fns.values():
    f.launches = 0
sys.argv = ["frodo_slam_tpu_torch.main"] + sys.argv[2:]
runpy.run_module("frodo_slam_tpu_torch.main", run_name="__main__")
print("kernel_launches " + json.dumps({k: f.launches for k, f in fns.items()}), flush=True)
"""


def phase_cli_fps_main(frames=64):
    """``tools/cli_fps.py --frames 64`` on the card: the committed runner with
    configs/bench_cli.yaml (f32 heads, x64 off, threaded, pipelined, gates
    off), ViT-L 288x512, identical frames: the track-only regime (no
    keyframe after the first, so no backend solve). Its JSON line printed
    as it is; the runner's own kernel launches beside it."""
    from frodo_slam_tpu_torch.tools import cli_fps

    real = cli_fps.runner_cmd
    wrappers = json.dumps({k: (fn.__module__, fn.__name__) for k, fn in WRAPPERS.items()})
    cli_fps.runner_cmd = lambda seq, cfg, n: [sys.executable, "-c", CLI_FPS_SHIM, wrappers,
                                              *real(seq, cfg, n)[3:]]
    try:
        t0 = time.perf_counter()
        line, proc = cli_fps.measure(frames, timeout=900)
        wall_s = time.perf_counter() - t0
    finally:
        cli_fps.runner_cmd = real
    print(json.dumps(line), flush=True)
    got = [ln for ln in proc.stdout.splitlines() if ln.startswith("kernel_launches ")]
    launches = json.loads(got[-1].split(" ", 1)[1]) if got else None
    emit("cli_fps_main", wall_s=wall_s, value=line["value"], windows=line["windows"], x64_eval=line["x64_eval"],
         card=line["card"], launches=launches)
    if line["rc"] != 0 or launches is None:
        raise AssertionError(f"cli_fps run failed (rc {line['rc']}):\n{proc.stderr[-3000:]}")
    assert line["value"] is not None and line["value"] > 0 and len(line["windows"]) == frames // 30, line
    assert line["x64_eval"] is False, line
    assert launches["flash_attention"] > 0 and launches["refine_matches"] > 0, launches
    return dict(line=line, launches=launches)


# ---------------------------------------------------------------------------
# bench_main: the end-to-end bench through the port
# ---------------------------------------------------------------------------

# the 64-pose window solved on the card vs on the CPU: the f32 bar of
# realtime_backend_main's window solve (which read 3.9e-6 at 16 poses)
BENCH_SOLVE_BAR = RT_SOLVE_BAR[False]


def _bench_child(env_extra: dict, timeout: float):
    """``python -m frodo_slam_tpu_torch.tools.bench`` in a child process with
    ``env_extra`` set. Returns (its last line, its detail line, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "frodo_slam_tpu_torch.tools.bench"], cwd=ROOT,
                          env=dict(os.environ, **env_extra), capture_output=True, text=True, timeout=timeout)
    wall_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"bench {env_extra} failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1]), json.loads(lines[-2]), wall_s


def _bench_window_solve():
    """One solve of the tool's 64-pose window (288x512 points, 126 live
    rows of 128), its poses perturbed with the tool's noise: on the card
    (f32, the ray kernel; synced, three times) against the CPU's plain
    version on the same inputs, within BENCH_SOLVE_BAR. The first GN
    iteration's ray-kernel call is timed alone beside its bound and held
    against the plain version."""
    from frodo_slam_tpu_torch.tools import bench as tool

    cfg = make_config()
    ba = global_opt.BAConfig(max_iters=int(cfg.local_opt.max_iters), pin=1,
                             delta_norm=float(cfg.local_opt.delta_norm), solve_f64=False)
    win_cpu = tool.steady_state_window(*tool.window_world(288 * 512, tool.WINDOW))
    P = win_cpu.poses
    T0_cpu = lie.sim3_retr(win_cpu.T_true, tool.perturb_noise(3, P))
    cuda = lambda t: None if t is None else t.to(DEV)  # noqa: E731
    X, C, T0 = win_cpu.X.to(DEV), win_cpu.C.to(DEV), T0_cpu.to(DEV)
    edges = global_opt.Edges(*map(cuda, win_cpu.edges))
    odom, odom_cpu = global_opt.empty_odom_edges(1, device=DEV), global_opt.empty_odom_edges(1)
    s_bar = torch.full((P,), -1.0)
    calls = []
    real = global_opt.ray_edge_systems

    def first_call(*a, **k):  # keep the first call's inputs
        if not calls:
            calls.append((a, k))
        return real(*a, **k)

    global_opt.ray_edge_systems = first_call
    try:
        ms, st = [], {}
        l0 = ba_reduce_kernel.ray_edge_systems.launches
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = global_opt.solve_gn_rays(ba, 1, T0, X, C, edges, odom, s_bar.to(DEV), stats=st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        launched = (ba_reduce_kernel.ray_edge_systems.launches - l0) // 3
    finally:
        global_opt.ray_edge_systems = real
    st_cpu = {}
    want = global_opt.solve_gn_rays(ba, 1, T0_cpu, win_cpu.X, win_cpu.C, win_cpu.edges, odom_cpu, s_bar,
                                    stats=st_cpu)
    a, k = calls[0]
    jj, active = a[4], a[5]
    A, D = kernel_cases.ray_counts(jj, active)
    E, N = int(jj.shape[0]), int(a[1].shape[2])
    run32 = lambda: ba_reduce_kernel.ray_edge_systems(*a, **k)  # noqa: E731
    B, g = run32()
    d64 = tuple(t.double() for t in a[:4]) + (jj, active)
    kw = {n: v for n, v in k.items() if n != "n_active"}
    Bp, gp = ba_reduce_kernel.ray_edge_systems_plain(*d64, **kw)
    live = active.cpu()
    ray = dict(E=E, N=N, A=A, D=D, err_f32=max(_rel_err(B, Bp, live), _rel_err(g, gp, live)),
               max_abs_err_f32=float(max((B.double() - Bp).abs().max(), (g.double() - gp).abs().max())),
               device_ms=cuda_ms_queued(run32), single_ms=cuda_ms(run32),
               plain_ms=cuda_ms(lambda: ba_reduce_kernel.ray_edge_systems_plain(*a, **kw), reps=3, warmup=1),
               **ray_bound(A, D, E, N))
    del Bp, gp, d64
    out = dict(poses=P, rows=E, live_rows=A, solve_ms=statistics.median(ms), all_ms=[round(x, 3) for x in ms],
               iters=st["iters"], iters_cpu=st_cpu["iters"], ray_launches=launched,
               card_vs_cpu=float((got.cpu() - want).abs().max()), step=float((want - T0_cpu).abs().max()),
               bar=BENCH_SOLVE_BAR, ray=ray)
    torch.cuda.empty_cache()
    return out


def phase_bench_main(frames=128, inline_frames=32):
    """``python -m frodo_slam_tpu_torch.tools.bench`` at ViT-L 288x512 in a
    child process: threaded at ``frames`` frames, then inline
    (``FRODO_BENCH_THREADED=0``) at ``inline_frames``. Each tool line is
    printed as it is, then held: rc 0, a positive FPS, TF32 off, backend
    work at a keyframe, the two decorrelated frames through the fnn
    fallback and rejected by the gate, every kernel launched in the timed
    passes and the ray kernel on the 128-row window. Then one window solve of the tool's
    world on the card against the CPU (``_bench_window_solve``)."""
    torch.cuda.empty_cache()
    runs = {}
    for name, env, timeout in (("threaded", {"FRODO_BENCH_FRAMES": str(frames), "FRODO_BENCH_THREADED": "1"}, 900),
                               ("inline", {"FRODO_BENCH_FRAMES": str(inline_frames), "FRODO_BENCH_THREADED": "0"},
                                600)):
        line, detail, wall_s = _bench_child(env, timeout)
        print(json.dumps(line), flush=True)
        tasks = detail["tasks_pass1"] + detail["tasks_pass2"]
        r = dict(wall_s=wall_s, launches=line["launches"], kf_frame_idx=detail["kf_frame_idx"],
                 decorrelated=detail["decorrelated"], launches_pass1=detail["launches_pass1"],
                 task_ms=[round(t["ms"], 3) for t in tasks], task_iters=[t["iters"] for t in tasks],
                 median_task_ms=statistics.median(t["ms"] for t in tasks) if tasks else None,
                 median_frame_ms_pass1=statistics.median(detail["frame_ms_pass1"][detail["warm_cut"]:]),
                 pass2_s=detail["pass2_s"], allow_tf32=detail["allow_tf32"])
        emit(f"bench_{name}", **r)
        runs[name] = r
        assert line["threaded"] is (name == "threaded") and line["frames"] == int(env["FRODO_BENCH_FRAMES"]) - 2
        assert line["value"] > 0 and line["synced_fps"] > 0, line
        assert line["kf_frames"] >= 1 and len(detail["tasks_pass1"]) == len(detail["tasks_pass2"]) \
            == line["kf_frames"], (line, detail["tasks_pass1"])
        if (line["fnn_frames"], line["gate_miss_frames"]) != (2, 2):
            raise AssertionError(f"bench {name}: fnn_frames {line['fnn_frames']}, gate_miss_frames "
                                 f"{line['gate_miss_frames']} (want 2, 2); decorrelated frames' flags "
                                 f"{detail['decorrelated']}")
        assert line["window_rows"] == 128 and line["x64_eval"] is False, line
        # the f32 heads' convolutions and matmuls ran in f32, as in SLAM
        assert detail["allow_tf32"] == {"cudnn": False, "matmul": False}, detail["allow_tf32"]
        for kname in PATH_KERNELS:
            assert line["launches"][kname] > 0, f"bench {name} never launched {kname}: {line['launches']}"
    solve = _bench_window_solve()
    emit("bench_window_solve", **solve)
    if not solve["card_vs_cpu"] <= solve["bar"]:
        raise AssertionError(f"the 64-pose window solve on the card is off the CPU's: {solve}")
    assert solve["ray_launches"] == solve["iters"] and solve["rows"] == 128, solve
    assert solve["ray"]["err_f32"] <= 1e-4, solve["ray"]
    return runs, solve


# ---------------------------------------------------------------------------
# vio_main: the robot VIO runner on a recorded session at full width
# ---------------------------------------------------------------------------

def _write_session(path: pathlib.Path, n_frames: int, h=360, w=640):
    """A recorded robot session as ``OdometryData`` reads it: identical
    360x640 BGR frames (16:9, so the runner's resize gives 288x512) and a
    metric SE(3) odometry pose per frame, 5 cm forward each."""
    import pickle

    img = (smooth_random_frames(1, h, w, seed=3)[0][:, :, ::-1] * 255).astype(np.uint8)
    rows = [{"timestamp": 0.1 * i, "frame": img, "pose": _vio_odom(i, step=0.05)} for i in range(n_frames)]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(rows, f)


def _vio_args(work, n_frames, **kw):
    """``run_vio``'s arguments for the recorded session of ``vio_main``: a
    config that inherits configs/base_no_fnn.yaml, threaded, every frame a
    keyframe, the height prior on, --use_odometry, every frame."""
    work = pathlib.Path(work or ROOT / "build" / "chip_smoke")
    session = work / "vio" / "session_mini.pkl"
    _write_session(session, n_frames)
    cfg = work / "vio_smoke.yaml"
    over = dict(FORCE_KEYFRAMES, height_prior={"enabled": True})
    cfg.write_text("\n".join([f'inherit: "{ROOT / "configs" / "base_no_fnn.yaml"}"', "single_thread: false"]
                             + [f"{k}: {json.dumps(v)}" for k, v in over.items()]) + "\n")
    return types.SimpleNamespace(**dict(dict(dataset=str(session), config=str(cfg), calib=None, weights=None,
                                             no_retrieval=True, use_odometry=True, wall_clock=False,
                                             every_n_frames=1, visualize=False, use_multiple_gpu=False), **kw))


def phase_vio_main(n_frames=16, work=None):
    """``python -m frodo_slam_tpu_torch.run_vio --dataset <session> --use_odometry
    --every_n_frames 1 --no-retrieval`` as ``run_vio.run_dataset``, ViT-L at
    288x512 with shared random decoders, a config that inherits
    configs/base_no_fnn.yaml (run_vio's default), threaded (as the robot
    runs), every tracked frame a keyframe, the height prior on. Per-frame and
    per-task ms (host clock; a task ends in its solve's fetches), the PGO's
    ms a keyframe (host, and synced on the final ring), its live count, the
    plane fits (rows fetched, ms, live targets), peak memory."""
    from frodo_slam_tpu_torch import run_vio
    from frodo_slam_tpu_torch.slam import pgo as pgo_mod
    from frodo_slam_tpu_torch.slam import system as system_mod
    from frodo_slam_tpu_torch.slam.height_prior import RectanglePlaneEstimator

    args = _vio_args(work, n_frames)
    rec = dict(frame_ms=[], task_ms=[], pgo_host_ms=[], pgo_ok=[], fit_rows=[], fit_ms=[], targets=[])
    real = dict(grab=SLAM.grab_rgb, task=SLAM._backend_step, pgo=SLAM._pgo_step, sbar=SLAM._height_prior_s_bar,
                fit=RectanglePlaneEstimator.run_points, opt=system_mod.pgo_optimize)

    def timed(key, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            rec[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    def opt(state):
        out = real["opt"](state)
        rec["pgo_ok"].append(out[2])  # read after the run: no fetch here
        return out

    def fit(self, pts, idx=None):
        rec["fit_rows"].append(int(np.asarray(pts).shape[0]))
        return real["fit"](self, pts, idx)

    def sbar(self, store, *a):
        t = time.perf_counter()
        out = real["sbar"](self, store, *a)
        rec["fit_ms"].append((time.perf_counter() - t) * 1e3)
        rec["targets"].append(None if out is None else [float(x) for x in out])
        return out

    failures = _Failures()
    logging.getLogger("frodo_slam_tpu_torch").addHandler(failures)
    SLAM.grab_rgb, SLAM._backend_step, SLAM._pgo_step = (timed("frame_ms", real["grab"]),
                                                         timed("task_ms", real["task"]),
                                                         timed("pgo_host_ms", real["pgo"]))
    SLAM._height_prior_s_bar, RectanglePlaneEstimator.run_points, system_mod.pgo_optimize = sbar, fit, opt
    env = os.environ.get("FRODO_RANDOM_SHARE_DECODER")
    os.environ["FRODO_RANDOM_SHARE_DECODER"] = "1"  # identical frames track (loader.py)
    try:
        at_start = reset_peak()
        zero_counts()
        t0 = time.perf_counter()
        slam = run_vio.run_dataset(args, device=DEV)  # terminated: the worker has drained
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        SLAM.grab_rgb, SLAM._backend_step, SLAM._pgo_step = real["grab"], real["task"], real["pgo"]
        SLAM._height_prior_s_bar, RectanglePlaneEstimator.run_points = real["sbar"], real["fit"]
        system_mod.pgo_optimize = real["opt"]
        logging.getLogger("frodo_slam_tpu_torch").removeHandler(failures)
        if env is None:
            os.environ.pop("FRODO_RANDOM_SHARE_DECODER", None)
        else:
            os.environ["FRODO_RANDOM_SHARE_DECODER"] = env
    peak = torch.cuda.max_memory_allocated()
    stamps, metric = slam.metric_keyframe_poses()
    poses = slam.keyframe_poses()[1]
    # the PGO on the final ring, synced: what a keyframe pays on the card
    ring = dataclasses.replace(slam.pgo, **{f: getattr(slam.pgo, f).clone() for f in ("Twc", "Todom", "scale")})
    T_copy = slam.store.T_WC.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        pgo_mod.pgo_add_frame(ring, torch.as_tensor(slam.current_T_WC), torch.as_tensor(_vio_odom(n_frames + i)))
        _, s_k, ok_k = pgo_mod.pgo_optimize(ring)
        pgo_mod.apply_pgo_scale_(T_copy, slam.store.n_size, s_k, ok_k)
    torch.cuda.synchronize()
    pgo_synced_ms = (time.perf_counter() - t0) * 1e3 / 20
    live = [x for row in rec["targets"] if row for x in row if x > 0]
    r = dict(frames=len(rec["frame_ms"]), image_hw=list(slam.img_hw), keyframes=len(stamps), run_s=run_s,
             frame_ms=[round(x, 3) for x in rec["frame_ms"]],
             median_frame_ms_after_first=statistics.median(rec["frame_ms"][1:]),
             task_ms=[round(x, 3) for x in rec["task_ms"]], median_task_ms=statistics.median(rec["task_ms"]),
             pgo_host_ms=[round(x, 3) for x in rec["pgo_host_ms"]], pgo_synced_ms=pgo_synced_ms,
             pgo_capacity=slam.pgo.capacity, pgo_ok=sum(bool(o) for o in rec["pgo_ok"]),
             pgo_keyframes=len(rec["pgo_ok"]), pgo_scale=float(slam.pgo.scale[0, 0]),
             plane_fits=len(rec["fit_rows"]), fit_rows=sorted(set(rec["fit_rows"])),
             fit_task_ms=[round(x, 3) for x in rec["fit_ms"]], live_targets=len(live),
             odometry_factors=len(slam.backend._odom_pairs), pairs=len(slam.backend._pairs),
             scale_channel=[round(float(x), 6) for x in poses[:, 7]], launches=launches,
             max_memory_allocated=peak, allocated_at_start=at_start,
             backend_task_failures=failures.records)
    emit("vio_main", **r)
    assert not failures.records, f"backend tasks failed: {failures.records}"
    assert slam.local_opt_mode and tuple(slam.img_hw) == (288, 512)
    assert r["frames"] == n_frames and len(stamps) == n_frames, (r["frames"], len(stamps))
    assert np.isfinite(metric).all() and np.isfinite(poses).all()
    assert r["odometry_factors"] > 0 and r["pgo_keyframes"] == n_frames - 1
    assert r["plane_fits"] > 0 and max(r["fit_rows"]) <= 1000
    for name in PATH_KERNELS:
        assert launches[name] > 0, f"vio_main never launched {name}"
    assert launches["resample"] == 2 * n_frames, f"not two resample launches a frame: {launches}"
    del slam
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# viz_main: the live map viewer over the VIO runner at full width
# ---------------------------------------------------------------------------

VIZ_PAUSE_AT = 4  # frames through before the client pauses the run
HTTP_TIMEOUT = 30.0


def _http(port, path, body=None, origin=None):
    """(status, body) of one request to the viewer, with a timeout."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    if origin is not None:
        req.add_header("Origin", origin)
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _until(pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _pause_step_resume(v, slam):
    """Pause the run, hold it for 1 s, step one frame, then try to resume it
    from a foreign origin (refused) and from the page's own."""
    ctl = lambda action, origin=None: _http(v.port, "/control", json.dumps({"action": action}).encode(),  # noqa: E731
                                            origin)[0]
    assert ctl("pause") == 200
    assert _until(lambda: v.holding), "the run did not stop at its frame gate"
    held = slam.frame_count
    time.sleep(1.0)
    assert slam.frame_count == held and v.holding, "a frame went through while paused"
    assert ctl("step") == 200
    assert _until(lambda: slam.frame_count == held + 1), "a step released no frame"
    assert _until(lambda: v.holding), "the run did not stop after the step"
    time.sleep(0.5)
    stepped = slam.frame_count - held
    assert stepped == 1, f"a step released {stepped} frames"
    foreign = ctl("resume", origin="http://elsewhere.example")
    assert foreign == 403 and v.paused, "a foreign origin resumed the run"
    assert ctl("resume", origin=f"http://127.0.0.1:{v.port}") == 200
    return dict(held_at=held, stepped=stepped, foreign_status=foreign)


def _viz_client(viewers, done, rec):
    """The browser's part: /state.json and /points.bin every 0.2 s; once
    VIZ_PAUSE_AT frames went through, the pause, step and resume."""
    import urllib.error

    try:
        assert _until(lambda: viewers), "no viewer started"
        v = viewers[0]
        while not done.is_set():
            try:
                code, state = _http(v.port, "/state.json")
                code2, pts = _http(v.port, "/points.bin")
            except (urllib.error.URLError, ConnectionError):
                if v._stop.is_set():
                    return  # the run ended and stopped its viewer
                raise
            assert code == code2 == 200, (code, code2)
            st = json.loads(state)
            rec["polls"] += 1
            rec["versions"].add(st["version"])
            rec["max_points_bytes"] = max(rec["max_points_bytes"], len(pts))
            if rec["pause"] is None and v.slam.frame_count >= VIZ_PAUSE_AT:
                rec["pause"] = _pause_step_resume(v, v.slam)
            done.wait(0.2)
    except Exception:  # reported by the phase, which fails on it
        import traceback

        rec["error"] = traceback.format_exc()


def _plain_points(T, X, C, N, thr, max_points):
    """The viewer's points recomputed in numpy from the store fetched to the
    host: the gate in f64, the JAX package's draw, s R X + t in f32."""
    conf = (C[..., 0].astype(np.float64) / np.maximum(N, 1)[:, None]).reshape(-1)
    keep = np.flatnonzero(conf > thr)
    if len(keep) > max_points:
        keep = keep[np.random.default_rng(0).choice(len(keep), max_points, replace=False)]
    Tk, Xk = T[keep // X.shape[1]], X.reshape(-1, 3)[keep]
    qv, qw = Tk[:, 3:6], Tk[:, 6:7]
    uv = 2.0 * np.cross(qv, Xk)
    Y = Tk[:, 7:8] * (Xk + qw * uv + np.cross(qv, uv)) + Tk[:, :3]
    return np.concatenate([Y, conf[keep][:, None]], axis=1).astype(np.float32)


def phase_viz_main(vio, n_frames=16, work=None):
    """``run_vio.run_dataset`` with ``--visualize`` on ``vio_main``'s session
    and config (threaded: the backend worker writes the store in place while
    the viewer reads it), the viewer on a free port, and a client thread in
    the browser's place. At the end a fresh viewer over the finished map
    must serve exactly the store's live poses, the backend's edges, and the
    points that numpy recomputes from the store fetched to the host."""
    import threading

    from frodo_slam_tpu_torch import run_vio
    from frodo_slam_tpu_torch.viz import visualization as viz
    from frodo_slam_tpu_torch.viz import web

    args = _vio_args(work, n_frames, visualize=True, viz_port=0)
    viewers, frame_ms = [], []
    rec = dict(polls=0, versions=set(), max_points_bytes=0, pause=None, error=None)
    real_viewer, real_grab = web.WebViewer, SLAM.grab_rgb

    class Recorded(real_viewer):
        def start(self):
            out = super().start()
            viewers.append(self)  # serving, on its bound port
            return out

    def grab(self, *a, **k):
        t = time.perf_counter()
        out = real_grab(self, *a, **k)
        frame_ms.append((time.perf_counter() - t) * 1e3)
        return out

    failures = _Failures()
    logging.getLogger("frodo_slam_tpu_torch").addHandler(failures)
    web.WebViewer, SLAM.grab_rgb = Recorded, grab
    env = os.environ.get("FRODO_RANDOM_SHARE_DECODER")
    os.environ["FRODO_RANDOM_SHARE_DECODER"] = "1"  # identical frames track (loader.py)
    done = threading.Event()
    client = threading.Thread(target=_viz_client, args=(viewers, done, rec), daemon=True)
    try:
        at_start = reset_peak()
        zero_counts()
        client.start()
        t0 = time.perf_counter()
        slam = run_vio.run_dataset(args, device=DEV)  # terminated, the viewer stopped
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        done.set()
        client.join(timeout=2 * HTTP_TIMEOUT)
        web.WebViewer, SLAM.grab_rgb = real_viewer, real_grab
        logging.getLogger("frodo_slam_tpu_torch").removeHandler(failures)
        if env is None:
            os.environ.pop("FRODO_RANDOM_SHARE_DECODER", None)
        else:
            os.environ["FRODO_RANDOM_SHARE_DECODER"] = env
    peak = torch.cuda.max_memory_allocated()
    assert not client.is_alive(), "the client thread hangs"
    assert rec["error"] is None, rec["error"]
    v, = viewers

    # a fresh viewer over the finished map, against the store on the host
    check = web.WebViewer(slam, port=0, interval_s=3600).start()
    try:
        assert _until(lambda: check._version > 0, 60), "no snapshot of the finished map"
        state = json.loads(_http(check.port, "/state.json")[1])
        pts = np.frombuffer(_http(check.port, "/points.bin")[1], np.float32).reshape(-1, 4)
    finally:
        check.stop()
    store = slam.store
    slots = viz.live_slots(store)
    T, X, C, N = (getattr(store, f)[slots].cpu().numpy() for f in ("T_WC", "X_canon", "C", "N"))
    logical0 = max(0, store.n_total - len(slots))
    edges = [[i - logical0, j - logical0] for i, j in slam.backend._pairs if i >= logical0 and j >= logical0]
    ref = _plain_points(T, X, C, N, check.conf_threshold, check.max_points)
    # the bar 1e-5 relative to max(1, |x|): random-weight pointmaps reach
    # thousands of units, where one f32 ulp exceeds 1e-5
    same = pts.shape == ref.shape and len(ref) > 0
    pts_err = float(np.max(np.abs(pts - ref) / np.maximum(1.0, np.abs(ref)))) if same else None
    pts_abs_err = float(np.abs(pts - ref).max()) if same else None
    snap_ms = [ms for _, ms, _ in v.snapshot_log]
    r = dict(frames=len(frame_ms), keyframes=store.n_size, run_s=run_s,
             frame_ms=[round(x, 3) for x in frame_ms],
             median_frame_ms_after_first=statistics.median(frame_ms[1:]),
             vio_main_median_frame_ms_after_first=vio["median_frame_ms_after_first"],
             snapshots=len(v.snapshot_log), snapshot_host_ms=[round(x, 3) for x in snap_ms],
             snapshot_read_ms=[round(x, 3) for x, _, _ in v.snapshot_log],
             snapshot_bytes=[b for _, _, b in v.snapshot_log],
             median_snapshot_host_ms=statistics.median(snap_ms) if snap_ms else None,
             polls=rec["polls"], versions_seen=len(rec["versions"]), max_points_bytes=rec["max_points_bytes"],
             pause=rec["pause"], viewer_errors=v.errors, check_errors=check.errors,
             final_points=len(pts), gated_points_max=check.max_points, points_max_err=pts_err,
             points_max_abs_err=pts_abs_err,
             final_abs_max=float(np.abs(ref[:, :3]).max()) if len(ref) else 0.0,
             T_WC_equal=bool(np.array_equal(np.asarray(state["T_WC"], np.float32), T)),
             edges_equal=state["edges"] == edges, n_edges=len(edges), launches=launches,
             max_memory_allocated=peak, allocated_at_start=at_start, backend_task_failures=failures.records)
    emit("viz_main", **r)
    assert not failures.records, f"errors logged: {failures.records}"
    assert v.errors == 0 and check.errors == 0, "the viewer counted errors"
    assert r["frames"] == n_frames and store.n_size == n_frames, (r["frames"], store.n_size)
    assert rec["polls"] > 0 and r["snapshots"] > 0 and rec["pause"] and rec["pause"]["stepped"] == 1
    assert max(r["snapshot_bytes"]) <= 16 * v.max_points + 32 * store.capacity
    assert r["T_WC_equal"] and r["edges_equal"] and state["n_kf"] == len(slots), "state.json is not the store"
    assert pts.shape == ref.shape and len(ref) > 0 and pts_err <= 1e-5, (pts.shape, ref.shape, pts_err)
    for name in PATH_KERNELS:
        assert launches[name] > 0, f"viz_main never launched {name}"
    assert launches["resample"] == 2 * n_frames, f"not two resample launches a frame: {launches}"
    del slam, v, check
    viewers.clear()
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# codebook_main: the ASMK codebook trainer at the record's width
# ---------------------------------------------------------------------------

def _write_pngs(folder: pathlib.Path, n: int, h: int, w: int, seed=7):
    """``n`` smooth random h x w frames as PNGs, made in batches of 32."""
    import PIL.Image

    folder.mkdir(parents=True, exist_ok=True)
    for i0 in range(0, n, 32):
        for j, img in enumerate(smooth_random_frames(min(32, n - i0), h, w, seed=seed + i0)):
            PIL.Image.fromarray((img * 255).astype(np.uint8)).save(folder / f"{i0 + j:04d}.png", compress_level=1)


def phase_codebook_main(n_images=224, h=288, w=512, k=65536, iters=20, small=(8192, 512, 5), work=None):
    """``python -m frodo_slam_tpu_torch.tools.train_codebook`` as its ``main``:
    the random-weight ViT-L encoder (MASt3RConfig() widths, seed 0) and the
    seeded random retrieval head (1024 -> 1024, nfeat 300) over ``n_images``
    smooth random PNGs written under build/chip_smoke/codebook/ and read
    through load_dataset, then mini-batch k-means to ``k`` words (batch
    65,536). Checks: the card's k-means against the CPU's at a small size
    (the first 8,192 features, 512 words, 5 iterations, the same numpy
    draws); the pickle's centroids finite and of unit norm;
    ``load_retriever`` on the card loads it as not degraded; a training
    image inserted with others is retrieved first. Collect ms per image
    (host, synced), encode + head ms per image (CUDA events), k-means ms per
    iteration (synced) beside its f32 bound, attention launches, peak
    memory."""
    import pickle
    import shutil

    from frodo_slam_tpu_torch import loader
    from frodo_slam_tpu_torch.data.datasets import load_dataset
    from frodo_slam_tpu_torch.slam.system import preprocess_image
    from frodo_slam_tpu_torch.tools import train_codebook as tc

    work = pathlib.Path(work or ROOT / "build" / "chip_smoke") / "codebook"
    folder = work / "images"
    shutil.rmtree(folder, ignore_errors=True)
    t0 = time.perf_counter()
    _write_pngs(folder, n_images, h, w)
    write_s = time.perf_counter() - t0
    out = work / "codebook.pkl"
    rec = {}
    real = dict(collect=tc.collect_features, kmeans=tc.minibatch_kmeans)

    def collect(model, head, dataset, max_images):
        torch.cuda.synchronize()
        t = time.perf_counter()
        feats = real["collect"](model, head, dataset, max_images)
        torch.cuda.synchronize()
        rec.update(collect_s=time.perf_counter() - t, model=model, head=head, feats=feats)
        return feats

    def kmeans(rng, feats, k, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cents = real["kmeans"](rng, feats, k, **kw)
        torch.cuda.synchronize()
        rec["kmeans_s"] = time.perf_counter() - t
        return cents

    tc.collect_features, tc.minibatch_kmeans = collect, kmeans
    try:
        at_start = reset_peak()
        zero_counts()
        summary = tc.main(["--dataset", str(folder), "--out", str(out), "--centroids", str(k),
                           "--max-images", str(n_images), "--iters", str(iters), "--seed", "0"])
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        tc.collect_features, tc.minibatch_kmeans = real["collect"], real["kmeans"]
    model, head, feats = rec.pop("model"), rec.pop("head"), rec.pop("feats")
    n, d = feats.shape

    # the card against the CPU at a small size, on the same numpy draws
    sn, sk, sit = small
    xs = feats[:sn]
    card = tc.minibatch_kmeans(np.random.default_rng(1), xs, sk, iters=sit)
    cpu = tc.minibatch_kmeans(np.random.default_rng(1), xs.cpu(), sk, iters=sit)
    small_err = float((card.cpu() - cpu).abs().max())
    small_agree = float((tc._assign(xs, card, 8192).cpu() == tc._assign(xs.cpu(), cpu, 8192)).double().mean())

    with open(out, "rb") as f:
        data = pickle.load(f)
    cents = data["centroids"]
    norm_err = float(np.abs(np.linalg.norm(cents.astype(np.float64), axis=1) - 1.0).max())
    db = loader.load_retriever(model.cfg, codebook_path=str(out), device=DEV)
    ds = load_dataset(str(folder))

    def encode(i):
        x = torch.from_numpy(np.ascontiguousarray(preprocess_image(ds[i][1], (h, w), False), np.float32)).to(DEV)
        return mast3r.encode_image(model, x)[0]

    ids = [0, n_images // 3, 2 * n_images // 3, n_images - 1]
    for kf, i in enumerate(ids):
        db.update(encode(i), add_after_query=True, k=5, kf_id=kf)
    hits = db.update(encode(ids[2]), add_after_query=False, k=5)
    x = torch.from_numpy(np.ascontiguousarray(preprocess_image(ds[0][1], (h, w), False), np.float32)).to(DEV)
    encode_ms = cuda_ms(lambda: head.prep_features(mast3r.encode_image(model, x)[0]))
    batch = min(65536, n)
    r = dict(images=summary["images"], image_hw=[h, w], features=n, dim=d, words=k, iters=iters, batch=batch,
             write_pngs_s=write_s, collect_ms_per_image=rec["collect_s"] * 1e3 / n_images,
             encode_ms_per_image=encode_ms, kmeans_s=rec["kmeans_s"],
             kmeans_ms_per_iter=rec["kmeans_s"] * 1e3 / iters,
             kmeans_bound_ms_per_iter=2.0 * batch * d * k / F32_OPS_PER_S * 1e3,
             small=dict(n=sn, k=sk, iters=sit, max_abs_err=small_err, assign_agree=small_agree),
             centroids=list(cents.shape), finite=bool(np.isfinite(cents).all()), norm_err=norm_err,
             degraded=db.degraded, query_hits=hits, query_id=2, launches=launches,
             attention_per_image=launches["flash_attention"] / n_images,
             max_memory_allocated=peak, allocated_at_start=at_start)
    emit("codebook_main", **r)
    assert n == n_images * head.nfeat and n > k, (n, k)
    assert small_err <= 1e-5 and small_agree >= 0.999, r["small"]
    assert r["centroids"] == [k, d] and r["finite"] and norm_err <= 1e-5, (r["centroids"], norm_err)
    assert not db.degraded, "the trained codebook loads degraded"
    assert hits and hits[0] == 2, f"the training image was not retrieved first: {hits}"
    assert launches["flash_attention"] == n_images * model.cfg.enc_depth, launches
    del model, head, feats, db, card, xs
    torch.cuda.empty_cache()
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
    for name in PATH_KERNELS:
        assert r["launches"][name] > 0, f"reloc_main never launched {name}"
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# synthetic: the oracle harness on the card
# ---------------------------------------------------------------------------

SYNTH_ROWS = [("straight", ["--frames", "10", "--noise", "0.003"]),
              ("per_frame", ["--per-frame", "--frames", "10", "--noise", "0.003"]),
              ("loop", ["--loop", "--frames", "14", "--noise", "0.004"]),
              ("vio", ["--vio", "--frames", "16", "--noise", "0.002"])]


def phase_synthetic():
    """Each row in a subprocess (the oracle patches the model module-wide),
    held to the JAX package's bars (tests/test_synthetic_e2e.py)."""
    rows, launches = {}, {name: 0 for name in WRAPPERS}
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
    s, pf, lp, vio = rows["straight"], rows["per_frame"], rows["loop"], rows["vio"]
    on, off = lp["loop"], lp["no_retrieval"]
    assert s["frames_tracked_ok"] == 10 and s["n_kf"] == 10 and s["ate_rmse"] < 0.05, s
    assert pf["frames_tracked_ok"] == 10 and pf["n_kf"] < 10 and pf["ate_rmse"] < 0.05, pf
    assert on["frames_tracked_ok"] == off["frames_tracked_ok"] == 14, lp
    assert on["n_long_loop_edges"] >= 1 and off["n_loop_edges"] == 0, lp
    assert on["ate_rmse"] <= off["ate_rmse"] * 1.05, lp
    v_on, v_off = vio["vio"], vio["no_odom"]  # tests/test_synthetic_e2e.py:126-134
    assert v_on["frames_tracked_ok"] == v_off["frames_tracked_ok"] == 16, vio
    assert v_on["ate_sim3"] < 0.03 and v_on["ate_se3_scaled"] < 0.06, vio
    assert v_on["ate_se3_scaled"] < 0.5 * v_off["ate_se3_scaled"], vio
    assert launches["refine_matches"] > 0 and launches["ray_edge_systems"] > 0, launches
    return rows, launches


def main():
    t_start = time.perf_counter()
    set_f32_contract()
    phase_device()
    phase_build()
    refine = phase_refine()
    attn = phase_attention()
    rope = phase_rope()
    resample = phase_resample()
    phase_tiny()
    main_launches, _ = phase_main()
    per_ray = phase_ray_reduce()
    per_calib = phase_calib()
    phase_backend_tiny()
    phase_calib_tiny()
    phase_vio_tiny()
    ser, thr = phase_backend_main()
    placed, _ = phase_placement_main()
    ds = phase_dataset_main()
    rt = phase_realtime_main()
    rt_runs, _ = phase_realtime_backend_main()
    fps = phase_cli_fps_main()
    bench, bench_solve = phase_bench_main()
    reloc = phase_reloc_main()
    vio = phase_vio_main()
    viz = phase_viz_main(vio)
    cb = phase_codebook_main()
    _, synth = phase_synthetic()
    # the ray kernel's time on the window case of the edge rows the backend
    # path handed it last
    E_main = ser["edge_rows"][-1]
    ray_t = per_ray[{16: "win16_8p", 32: "win32_11p"}.get(E_main, f"all{E_main}")]
    rf = refine["384x512"]
    at = attn[0]  # the encoder at 768 tokens: (1, 16, 768, 64) bf16
    rp = rope[0]  # the same encoder's qkv split
    per_path = lambda name: {"main": main_launches[name],  # noqa: E731
                             "backend_main": [ser["launches"][name], thr["launches"][name]],
                             "placement_main": [placed["shared"]["launches"][name],
                                                placed["overlap"]["launches"][name]],
                             "dataset_main": ds["launches"][name],
                             "realtime_main": rt["launches"][name],
                             "realtime_backend_main": [rt_runs[False]["launches"][name],
                                                       rt_runs[True]["launches"][name]],
                             "cli_fps_main": fps["launches"][name],
                             "bench_main": [bench["threaded"]["launches"].get(name),  # the tool counts no resample
                                            bench["inline"]["launches"].get(name)],
                             "reloc_main": reloc["launches"][name],
                             "vio_main": vio["launches"][name],
                             "viz_main": viz["launches"][name],
                             "codebook_main": cb["launches"][name],
                             "synthetic": synth[name]}
    kernels = [{
        "name": "refine_matches",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/refine_matches.cu",
        "replaces": "frodo_slam_tpu/ops/refine_fused_pallas.py:303",
        "also_replaces": "frodo_slam_tpu/ops/refine_fused_pallas.py:322",
        "launches": ds["launches"]["refine_matches"],
        "launches_per_path": per_path("refine_matches"),
        "shape": rf["shape"],
        "equal_to_plain": True,
        "max_abs_err": rf["max_abs_err"],
        "ms": rf["ms"],
        "ms_smooth": rf["ms_smooth"],
        "plain_ms": rf["plain_ms"],
        "bound_ms": rf["bound_ms"],
        "bound_by": rf["bound_by"],
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
        "bench_window": {k: bench_solve["ray"][k] for k in ("E", "A", "D", "N", "device_ms", "single_ms", "plain_ms",
                                                             "bound_ms", "bound_by", "err_f32")},
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
    }, {
        "name": "rope2d",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/rope2d.cu",
        "replaces": None,  # eager PyTorch RoPE; XLA fused it on the TPU
        "launches": ds["launches"]["rope2d"],
        "launches_per_path": per_path("rope2d"),
        "shape": rp["shape"],
        "equal_to_plain": True,
        "ms": rp["ms"],
        "plain_ms": rp["plain_ms"],
        "per_call_ms": rp["per_call_ms"],
        "host_us": rp["host_us"],
        "per_call_host_us": rp["per_call_host_us"],
        "bound_ms": rp["bound_ms"],
        "bound_by": rp["bound_by"],
        "library_ms": None,
        "per_shape": {"x".join(map(str, r["shape"])) + f"_{r['dtype']}_{r['layout']}":
                      {f: r[f] for f in ("ms", "plain_ms", "per_call_ms", "host_us", "per_call_host_us", "bound_ms")}
                      for r in rope},
    }, {
        "name": "resample",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/resample.cu",
        "replaces": None,  # PIL's resize on the host in both packages
        # two a resized frame (the bench tool does not count it; its 288x512
        # frames need no resize)
        "launches_per_path": per_path("resample"),
        "shape": resample[0]["shape"],
        "equal_to_plain": True,
        "ms": resample[0]["ms"],
        "plain_ms": resample[0]["plain_ms"],
        "host_us": resample[0]["host_us"],
        "call_host_ms": resample[0]["call_host_ms"],
        "host_path_ms": resample[0]["host_path_ms"],
        "bound_ms": resample[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "per_shape": {"x".join(map(str, r["shape"])): {f: r[f] for f in ("ms", "plain_ms", "host_us", "call_host_ms",
                                                                          "host_path_ms", "bound_ms")}
                      for r in resample},
    }, {
        "name": "calib_edge_systems",
        "route": "cuda",
        "source": "frodo_slam_tpu_torch/csrc/calib_edge_systems.cu",
        "replaces": None,  # XLA's reduction of the calibrated edges on the TPU
        "launches": ds["launches"]["calib_edge_systems"],
        "launches_per_path": per_path("calib_edge_systems"),
        "shape": [per_calib["win64"]["E"], per_calib["win64"]["N"]],
        "case": "win64",
        "max_rel_err": per_calib["win64"]["err_f32"],
        "ms": per_calib["win64"]["device_ms"],
        "single_ms": per_calib["win64"]["single_ms"],
        "plain_ms": per_calib["win64"]["plain_ms"],
        "bound_ms": per_calib["win64"]["bound_ms"],
        "bound_by": per_calib["win64"]["bound_by"],
        "library_ms": None,
        "cell_rate": per_calib["cell"]["rate"],
        "per_case": {c: {k: v[k] for k in ("E", "A", "D", "device_ms", "single_ms", "host_us", "plain_ms",
                                           "f64_device_ms", "bound_ms", "f64_bound_ms", "err_f32", "err_f64")}
                     for c, v in per_calib.items() if c != "cell"},
    }]
    emit("total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
