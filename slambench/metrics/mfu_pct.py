"""The whole step's share of the card's dense bf16 peak (989 TFLOP/s): the
model's operations in the traced slice (the frozen ``model_flops`` count of
an encode and a pair decode with both heads, a frame; the pair decode again
for each keyframe task's missing direction) over the slice's seconds."""


def read(s):
    if s["window_s"] <= 0 or not s["slice_frames"]:
        return None
    ops = s["slice_frames"] * s["flops_frame"] + s["slice_kf_tasks"] * s["flops_backend_decode"]
    return 100.0 * ops / s["window_s"] / s["bf16_peak"]
