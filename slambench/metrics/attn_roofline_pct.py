"""The attention kernel's share of its roofline: the least time of the
attention work of the slice's forwards (the frozen
``forward_attention_bound`` of each of the program's ``model.encode`` and
``model.decode`` spans, at its ``batch``, 1 where the span has none) over
the kernel's device time in the trace. The work is counted from the
forwards, not from Python calls, so it reads the same whatever runs the
attention: eager calls, a CUDA graph's replay, a fused kernel."""

from slambench.yardstick import forward_attention_bound

PART = {"model.encode": "encode", "model.decode": "decode"}


def read(s):
    t = s["kernel_time_s"].get("attention", 0.0)
    if not s["model_calls"] or t <= 0:
        return None
    a = s["attention_shape"]
    work = sum(n * forward_attention_bound(a["widths"], a["img_hw"], b, a["dtype"])[PART[name]]
               for name, b, n in s["model_calls"])
    return 100.0 * work / t
