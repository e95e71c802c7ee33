"""Where a frontend frame's time goes on the card.

    python -m frodo_slam_tpu_torch.tools.profile_frontend [--frames 10] [--warmup 2]

Runs the chip smoke's main path (ViT-L widths, random weights from seed 0,
smooth random 288x512 frames, default config, backend and reloc off) twice:

1. under ``torch.profiler``: kernel launches per frame, device busy share of
   the window (summed kernel time / host wall time), top kernels by device
   time, and the hand-written kernels' ms and calls per frame;
2. with every stage wrapped in ``torch.cuda.synchronize()`` + host clock:
   encode, pair decode + heads, matcher LM (prep + iter_proj), matcher rest
   (occlusion gate + refine + score gate; the refine alone too), fnn
   fallback, GN (with its iteration count), the rest of the post step.
   The syncs add their own cost; these are synced stage times.

Prints one JSON line per result. Needs a card; CPU only for a dry run with
``--device cpu --tiny``.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import time

import torch

from ..config import make_config
from ..data.synthetic import smooth_random_frames
from ..models import mast3r
from ..ops import matching
from ..slam import inference as inference_mod
from ..slam import tracker
from ..slam.system import SLAM


# the hand-written kernels' function names (csrc/), reported on their own
OWN_KERNELS = ("flash_fwd", "refine_", "ray_edge")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make(args):
    dev = torch.device(args.device)
    cfg = mast3r.tiny_config() if args.tiny else mast3r.MASt3RConfig()
    hw = (32, 64) if args.tiny else (288, 512)
    model = mast3r.init_model(cfg, seed=0, device=dev)
    slam = SLAM(make_config(), model, hw, use_backend=False, device=dev)
    frames = smooth_random_frames(args.warmup + args.frames, *hw)
    return dev, slam, frames


def profile_kernels(args):
    from torch.profiler import ProfilerActivity, profile

    dev, slam, frames = _make(args)
    for i in range(args.warmup):
        slam.grab_rgb(frames[i], timestamp=float(i))
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for i in range(args.warmup, args.warmup + args.frames):
            slam.grab_rgb(frames[i], timestamp=float(i))
        _sync(dev)
    wall_us = (time.perf_counter() - t0) * 1e6
    n_kernels, kernel_us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            kernel_us += e.time_range.elapsed_us()
    top = []
    for a in prof.key_averages():
        dt = getattr(a, "self_device_time_total", 0.0)
        if dt > 0:
            top.append((dt, a.key, a.count))
    top.sort(reverse=True)
    own = {k: {"ms_per_frame": dt / 1e3 / args.frames, "calls_per_frame": c / args.frames}
           for dt, k, c in top if any(name in k for name in OWN_KERNELS)}
    print(json.dumps({
        "profile": "kernels", "frames": args.frames, "wall_ms_per_frame": wall_us / 1e3 / args.frames,
        "kernel_launches_per_frame": n_kernels / args.frames,
        "kernel_ms_per_frame": kernel_us / 1e3 / args.frames,
        "device_busy_share": kernel_us / wall_us,
        "top": [{"kernel": k[:90], "ms_per_frame": dt / 1e3 / args.frames, "calls_per_frame": c / args.frames}
                for dt, k, c in top[:15]],
        "own_kernels": own,
    }), flush=True)


def profile_stages(args):
    dev, slam, frames = _make(args)
    acc = collections.defaultdict(float)
    calls = collections.Counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            _sync(dev)
            t = time.perf_counter()
            out = fn(*a, **kw)
            _sync(dev)
            acc[name] += (time.perf_counter() - t) * 1e3
            calls[name] += 1
            return out
        return wrapper

    patches = [
        (mast3r, "encode_image", "encode"),
        (inference_mod, "decode_asymmetric", "decode_heads"),
        (matching, "iter_proj", "matcher_lm"),
        (matching, "_match_post_project", "matcher_rest"),
        (matching, "refine_matches", "refine_kernel"),
        (tracker, "fast_reciprocal_nns", "fnn"),
        (tracker, "opt_pose_ray_dist_sim3", "gn"),
        (tracker, "track_step_post", "post_total"),
        (tracker, "_safe_cholesky", "gn_iterations"),
    ]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, label in patches:
            setattr(m, n, timed(label, getattr(m, n)))
        for i in range(args.warmup):
            slam.grab_rgb(frames[i], timestamp=float(i))
        acc.clear()
        calls.clear()
        frame_ms = []
        for i in range(args.warmup, args.warmup + args.frames):
            _sync(dev)
            t = time.perf_counter()
            slam.grab_rgb(frames[i], timestamp=float(i))
            _sync(dev)
            frame_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    n = args.frames
    stages = {k: v / n for k, v in acc.items() if k != "gn_iterations"}
    stages["post_other"] = stages.get("post_total", 0.0) - stages.get("fnn", 0.0) - stages.get("gn", 0.0)
    print(json.dumps({
        "profile": "stages", "frames": n, "frame_ms": frame_ms,
        "stage_ms_per_frame": stages, "calls": dict(calls),
        "gn_iterations_per_frame": calls["gn_iterations"] / n,
    }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="tiny_config at 32x64 (dry run)")
    args = ap.parse_args()
    print(json.dumps({"device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}),
          flush=True)
    profile_kernels(args)
    profile_stages(args)


if __name__ == "__main__":
    main()
