"""The tracking Gauss-Newton's iterations a tracked frame (each ends in one
host fetch): the program's ``tracker.gn_iters`` counter summed over the
frames that have a ``tracker.track_step`` span, over their number, in the
traced slice; None for a program without its own spans."""


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    recs = records()
    frames = {r["frame"] for r in recs if r["name"] == "tracker.track_step"}
    if not frames:
        return None
    return sum(r["counters"].get("tracker.gn_iters", 0) for r in recs if r["frame"] in frames) / len(frames)
