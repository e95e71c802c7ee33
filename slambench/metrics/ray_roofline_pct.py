"""The ray kernel's share of its roofline: the least time of every call in
the slice (the frozen ``ray_bound`` at each call's live rows and frames)
over the kernel's device time in the trace."""

from slambench.trace import ray_counts
from slambench.yardstick import ray_bound


def read(s):
    calls = s["calls"].get("ray", [])
    t = s["kernel_time_s"].get("ray", 0.0)
    if not calls or t <= 0:
        return None
    return 100.0 * sum(ray_bound(*ray_counts(c)) for c in calls) / t
