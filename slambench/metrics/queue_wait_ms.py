"""Median wait of a threaded backend task in the queue: the program's
``backend.task`` span's start less the ``queued_ns`` stamped when the
frontend queued it, in the traced slice; None for an inline backend or a
program without its own spans."""

import statistics


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    xs = [r["start_ns"] - r["attrs"]["queued_ns"] for r in records()
          if r["name"] == "backend.task" and r["attrs"].get("queued_ns") is not None]
    return 1e-6 * statistics.median(xs) if xs else None
