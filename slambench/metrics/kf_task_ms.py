"""Median host time of the program's ``backend.task`` span (a keyframe's
whole backend task: the store copy when threaded, the pair decodes,
matches and edge rows, the window, the solve, the merge) in the traced
slice; None for a program without its own spans."""

import statistics


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    xs = [r["end_ns"] - r["start_ns"] for r in records() if r["name"] == "backend.task"]
    return 1e-6 * statistics.median(xs) if xs else None
