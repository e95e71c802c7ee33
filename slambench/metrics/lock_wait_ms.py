"""The frontend's wait for the map's lock (``SLAM._backend_lock``), a frame:
the program's ``frame.lock_wait_ns`` counter on the thread that dispatches
frames, summed over the traced slice, over its frames; None for a program
without its own spans."""


def read(s):
    try:
        from frodo_slam_tpu_torch.utils.spans import records
    except ImportError:
        return None
    recs = records()
    front = {r["thread"] for r in recs if r["name"] == "frame.dispatch"}
    if not front or not s["slice_frames"]:
        return None
    ns = sum(r["counters"].get("frame.lock_wait_ns", 0) for r in recs if r["thread"] in front)
    return 1e-6 * ns / s["slice_frames"]
