"""Median host time of the program's ``frame.preprocess`` span (the resize
and normalisation of a camera frame and its upload from pageable memory)
in the traced slice; None for a program without its own spans."""

import statistics


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    xs = [r["end_ns"] - r["start_ns"] for r in records() if r["name"] == "frame.preprocess"]
    return 1e-6 * statistics.median(xs) if xs else None
