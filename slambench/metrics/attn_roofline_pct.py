"""The attention kernel's share of its roofline: the least time of every
call in the slice (the frozen ``attention_bound`` at each call's shapes)
over the kernel's device time in the trace."""

from slambench.yardstick import attention_bound


def read(s):
    calls = s["calls"].get("attention", [])
    t = s["kernel_time_s"].get("attention", 0.0)
    if not calls or t <= 0:
        return None
    return 100.0 * sum(attention_bound(*c) for c in calls) / t
