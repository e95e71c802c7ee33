"""The attention kernel's share of its roofline: the least time of the
attention work of the slice's forwards (the cell's architecture's frozen
``forward_bounds`` of each of the program's model spans, ``model.encode``
and ``model.decode`` for MASt3R, at its ``batch``, 1 where the span has
none) over the kernel's device time in the trace. The work is counted from
the forwards, not from Python calls, so it reads the same whatever runs the
attention: eager calls, a CUDA graph's replay, a fused kernel."""

from slambench.archs import load_arch


def read(s):
    t = s["kernel_time_s"].get("attention", 0.0)
    if not s["model_calls"] or t <= 0:
        return None
    a = s["model_shape"]
    bounds = load_arch(s["arch"], s["arch_root"]).forward_bounds
    work = sum(n * bounds(a["widths"], a["img_hw"], b, a["dtype"])[name] for name, b, n in s["model_calls"])
    return 100.0 * work / t
