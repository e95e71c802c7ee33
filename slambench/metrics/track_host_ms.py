"""Median host time of the program's ``tracker.track_step`` span (the pair
decode, the matcher, the Gauss-Newton with its per-iteration fetches, the
fusion) in the traced slice."""

import statistics


def read(s):
    xs = s["span_host_s"].get("tracker.track_step", [])
    return 1e3 * statistics.median(xs) if xs else None
