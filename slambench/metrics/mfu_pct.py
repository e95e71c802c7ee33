"""The whole step's share of the card's dense bf16 peak (989 TFLOP/s): the
model's operations in the traced slice (the cell's architecture's frozen
``flops``: ``total`` a frame, for MASt3R an encode and a pair decode with
both heads; ``total`` less ``encode``, the pair decode, again for each
keyframe task's missing direction) over the slice's seconds."""

from slambench.archs import load_arch
from slambench.yardstick import BF16_OPS_PER_S


def read(s):
    if s["window_s"] <= 0 or not s["slice_frames"]:
        return None
    a = s["model_shape"]
    fl = load_arch(s["arch"], s["arch_root"]).flops(a["widths"], a["img_hw"])
    ops = s["slice_frames"] * fl["total"] + s["slice_kf_tasks"] * (fl["total"] - fl["encode"])
    return 100.0 * ops / s["window_s"] / BF16_OPS_PER_S
