"""How often the window solve's GN step runs as one CUDA graph replay: the
program's ``backend.step_replays`` counter summed over the traced slice's
``backend.solve_rays`` / ``backend.solve_calib`` records, over their
``backend.solve_iters`` summed the same way (1.0: every iteration
replayed). None where no such record carries the replay counter (a
program without it, or a slice without a solve) or no iteration ran."""

SOLVES = ("backend.solve_rays", "backend.solve_calib")


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    solves = [r for r in records() if r["name"] in SOLVES]
    if not any("backend.step_replays" in r["counters"] for r in solves):
        return None
    iters = sum(r["counters"].get("backend.solve_iters", 0) for r in solves)
    if not iters:
        return None
    return sum(r["counters"].get("backend.step_replays", 0) for r in solves) / iters
