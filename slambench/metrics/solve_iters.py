"""Gauss-Newton iterations a window solve (each ends in one host fetch):
the program's ``backend.solve_iters`` counter summed over the traced
slice's ``backend.solve_rays`` / ``backend.solve_calib`` records, over
their number; None where no such record carries the counter (a program
without it, or a slice without a solve)."""

SOLVES = ("backend.solve_rays", "backend.solve_calib")


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    solves = [r for r in records() if r["name"] in SOLVES]
    if not any("backend.solve_iters" in r["counters"] for r in solves):
        return None
    return sum(r["counters"].get("backend.solve_iters", 0) for r in solves) / len(solves)
