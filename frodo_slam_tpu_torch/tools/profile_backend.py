"""Where a backend window solve's time goes on the card.

    python -m frodo_slam_tpu_torch.tools.profile_backend [--keyframes 12] [--solves 3] [--no-odom] [--calib]

Builds the state of chip_smoke's backend_main run (ViT-L widths, random
weights from seed 0 with shared heads and decoders, identical smooth random
288x512 frames, every frame a keyframe, an odometry pose per frame unless
``--no-odom``, serialized backend), then solves the final window again
``--solves`` times. ``--calib`` builds the state of the dataset path
instead (chip_smoke's dataset_main): 384x512 frames, TUM fr1's calibration,
the calibrated tracker and window solve, no odometry.

1. with every stage wrapped in ``torch.cuda.synchronize()`` + host clock:
   the window build, the points constrained to their rays (``--calib``),
   the edge inputs (``XjT`` gather), per GN iteration the ray edge systems
   (kernel + AdjInv) or the calibrated ones, the odometry systems
   (closed-form Jacobians), the dense assembly (scatter), and the rest
   (scale prior, f64 Cholesky, retraction, the early-exit fetch); the syncs
   add their own cost;
2. under ``torch.profiler``: kernel launches per solve, summed kernel time,
   device busy share of the window, top kernels by device time.

Prints one JSON line per result. Needs a card; CPU only for a dry run with
``--device cpu --tiny``.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from ..config import make_config
from ..data.datasets import Intrinsics
from ..data.synthetic import smooth_random_frames
from ..models import mast3r
from ..slam import backend as backend_mod
from ..slam import global_opt
from ..slam.system import SLAM

TUM_FR1 = [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build(args):
    dev = torch.device(args.device)
    cfg = mast3r.tiny_config() if args.tiny else mast3r.MASt3RConfig()
    hw = (32, 64) if args.tiny else ((384, 512) if args.calib else (288, 512))
    model = mast3r.init_model(cfg, seed=0, device=dev)
    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    # the network-crop K of a 640x480 TUM fr1 frame, rescaled to this grid
    K = Intrinsics.from_calib(max(hw), 640, 480, TUM_FR1, True).K_frame if args.calib else None
    slam = SLAM(make_config(
        use_calib=args.calib,
        tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0}), model, hw, calib=K, device=dev)
    img = smooth_random_frames(1, *hw, seed=3)[0]
    for i in range(args.keyframes):
        odom = None if args.no_odom or args.calib else np.array([0.05 * i, 0.01 * i, 0, 0, 0, 0, 1.0],
                                                                np.float32)
        ok, _, new_kf = slam.grab_rgb(img, timestamp=float(i), odom_pose=odom)
        assert ok and new_kf
    return dev, slam


def _solve(slam):
    if slam.tcfg.use_calib:
        return slam.backend.solve_window_calib(slam.store, slam.K)
    return slam.backend.solve_window_rays(slam.store)


def stage_times(args, dev, slam):
    """Synced stage times of ``--solves`` window solves."""
    be = slam.backend
    acc = collections.defaultdict(float)
    names = {"ray_edge_systems": "ray_kernel", "_calib_edge_systems": "calib_edge_systems",
             "_odom_systems": "odometry", "_scatter_block": "assembly_scatter",
             "_edge_inputs": "edge_inputs"}
    real = {name: getattr(global_opt, name) for name in names}
    real_constrain = backend_mod.constrain_points_to_ray
    real_adj = global_opt._adj_inv_matrix

    def timed(key, fn):
        def wrapper(*a, **k):
            _sync(dev)
            t = time.perf_counter()
            out = fn(*a, **k)
            _sync(dev)
            acc[key] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    for name, fn in real.items():
        setattr(global_opt, name, timed(names[name], fn))
    global_opt._adj_inv_matrix = timed("adj_inv_and_scal", real_adj)
    backend_mod.constrain_points_to_ray = timed("constrain_to_rays", real_constrain)
    build = timed("window_build", be._build_window)
    be._build_window = build
    iters = 0
    total = 0.0
    try:
        for _ in range(args.solves):
            _sync(dev)
            t = time.perf_counter()
            _solve(slam)
            _sync(dev)
            total += (time.perf_counter() - t) * 1e3
            iters += be.last_solve["iters"]
    finally:
        for name, fn in real.items():
            setattr(global_opt, name, fn)
        global_opt._adj_inv_matrix = real_adj
        backend_mod.constrain_points_to_ray = real_constrain
        del be._build_window
    out = {k: v / args.solves for k, v in acc.items()}
    out["solve_total"] = total / args.solves
    out["rest_cholesky_retract_fetch"] = out["solve_total"] - sum(v for k, v in out.items()
                                                                 if k != "solve_total")
    print(json.dumps({"stage_ms_per_solve": out, "gn_iters_per_solve": iters / args.solves,
                      "window": be.last_solve, "odometry_rows": be._n_odom, "device": dev.type}),
          flush=True)


def profile_solves(args, dev, slam):
    from torch.profiler import ProfilerActivity, profile

    be = slam.backend
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(args.solves):
            _solve(slam)
        _sync(dev)
    wall = (time.perf_counter() - t) * 1e3
    # device events only (key_averages also lists the aten ops that launch them)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top = sorted(((getattr(a, "self_device_time_total", 0.0), a.key, a.count)
                  for a in prof.key_averages()), reverse=True)[:8]
    print(json.dumps({
        "profiled_solves": args.solves, "wall_ms_per_solve": wall / args.solves,
        "kernel_launches_per_solve": len(kernels) / args.solves,
        "kernel_ms_per_solve": dev_ms / args.solves,
        "device_busy_share": dev_ms / wall if wall else None,
        "top": [{"name": k[:80], "calls_per_solve": c / args.solves,
                 "ms_per_solve": dt / 1e3 / args.solves} for dt, k, c in top if dt > 0],
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=12)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--no-odom", action="store_true", help="frames without odometry poses")
    ap.add_argument("--calib", action="store_true",
                    help="the dataset path: 384x512, TUM fr1's calibration, the calibrated solve")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_backend: no CUDA device (use --device cpu --tiny for a dry run)")
    dev, slam = _build(args)
    if dev.type == "cuda":
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    stage_times(args, dev, slam)
    profile_solves(args, dev, slam)
    slam.terminate()


if __name__ == "__main__":
    main()
