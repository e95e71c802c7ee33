"""The readings that the limits of ``limits/<config>.json`` are set from.

    python -m slambench.study --workload <cell> --seeds <n> [--first <seed>] [--seconds <s>]
                              [--control <n>] [--heads-bf16 <n>]

For each seed, in one process: one short run of the cell (its set-up, a
window of ``--seconds``, whole sessions) and the numbers that the
comparison gives, one JSON line each (``"kind": "program"``). With
``--control n``, for the first n seeds the reference in the program's
place one step below the stated precision (the cell's architecture's
``make_reference(precision="control")``) and compared as the program is
(``"kind": "control"``). With ``--heads-bf16 n``, for the first n seeds the
program with its own bf16 head path switched on (``tpu.head_dtype``)
(``"kind": "program_heads_bf16"``). Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time

import numpy as np
import torch

from . import reference, run


def control_checks(c, seed: int, device, n_frames: int):
    """The comparison's numbers for the control: every session of the cell
    stands in for by the control's pointmap and confidence (N times), the
    identity poses, the expected counts and, in the keyframe cells, the
    control's views as the backend's decodes; its heads (TF32 for MASt3R)
    are judged on its own head inputs."""
    arch = run.load_arch(c["arch"], c["root"])
    m = c["config"]["model"]
    tpu = c["config"]["tpu"]
    sd = arch.make_weights(m, seed, device, dtype=getattr(torch, tpu["dtype"]),
                           head_dtype=getattr(torch, tpu["head_dtype"]))
    ref, ctrl = arch.make_reference(sd, m), arch.make_reference(sd, m, precision="control")
    ref_bf16 = arch.make_reference(sd, m, precision="bf16")
    del sd
    h, w = int(c["config"]["camera"]["height"]), int(c["config"]["camera"]["width"])
    img = run.session_images((h, w), seed, 1)[0]
    net = arch.net_input(img, int(c["config"]["camera"]["long_side"]))
    X, C = arch.ref_views(ref, net, device)
    Xc, Cc, head = arch.control_views(ref, ctrl, net, device)
    thresh = float(c["traffic"]["match_frac_thresh"])
    exp = reference.expected_session(n_frames, thresh)
    n_kf = len(exp["slot_N"])
    eye = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float64)
    sess = {"image": 0, "n_submitted": n_frames,
            "frames": [(True, eye, f) for f in exp["kf_flags"]],
            "poses": np.stack([eye] * n_kf),
            "X": np.stack([Xc] * n_kf).astype(np.float32),
            "C": np.stack([Cc * n for n in exp["slot_N"]]).astype(np.float32),
            "N": np.asarray(exp["slot_N"]),
            "active": (Xc.astype(np.float32), (Cc * exp["active_N"]).astype(np.float32), exp["active_N"]),
            "pairs": [(i - 1, i) for i in range(1, n_kf)], "decodes": n_kf - 1,
            "backend_views": [(Xc.astype(np.float32), Cc.astype(np.float32))] * (4 if n_kf > 1 else 0),
            "solve_poses": n_kf if n_kf > 1 else 0}
    Xb, _ = arch.ref_views(ref_bf16, net, device)
    return dict(reference.compare([sess], {0: (X, C, Xb)}, thresh), head_rel_err=head)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=0, help="seeds that also run the control")
    p.add_argument("--heads-bf16", dest="heads_bf16", type=int, default=0,
                   help="seeds that also run the program with bf16 heads")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("slambench.study: no CUDA card", file=sys.stderr)
        return 2
    c = run.load_cell(args.workload)
    c["traffic"]["warmup_frames"] = 2  # nothing is timed here
    variants = [("program", c)]
    if args.heads_bf16:
        cb = copy.deepcopy(c)
        cb["slam_overrides"] = {"tpu": {"head_dtype": "bfloat16"}}
        variants.append(("program_heads_bf16", cb))
    limits = c["limits"]
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        for kind, cc in variants:
            if kind == "program_heads_bf16" and i >= args.heads_bf16:
                continue
            t = time.time()
            r = run.run_cell(cc, seed, args.seconds, False, "cuda", t)
            ok, _ = run.judge(r["checks"], limits)
            print(json.dumps({"kind": kind, "seed": seed, "correct_now": ok, "checks": r["checks"],
                              "fps": r["metrics"]["fps"], "s": time.time() - t}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        if i < args.control:
            n = int(c["traffic"]["session_frames"] or 8)
            print(json.dumps({"kind": "control", "seed": seed,
                              "checks": control_checks(c, seed, "cuda", n)}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
