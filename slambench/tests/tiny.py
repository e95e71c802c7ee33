"""A cell cut to a size that the CPU runs in seconds, for the rehearsals:
tiny widths (the program's ``tiny_config`` widths, a narrow DPT), a small
camera with the calibration scaled to it, sessions of at most 6 frames."""

import copy

from slambench import run

TINY = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=48, dec_depth=12,
            dec_num_heads=2, dpt_feature_dim=32, dpt_layer_dims=[8, 16, 32, 64])


def tiny_cell(workload: str):
    c = copy.deepcopy(run.load_cell(workload))
    cam = (96, 128) if c["config"]["camera"]["height"] * 4 == c["config"]["camera"]["width"] * 3 else (64, 128)
    c["config"]["model"].update(TINY)
    scale = cam[1] / c["config"]["camera"]["width"]
    c["config"]["camera"] = {"height": cam[0], "width": cam[1], "long_side": max(cam)}
    if c["config"]["calibration"]:
        c["config"]["calibration"] = [v * scale for v in c["config"]["calibration"]]
    for k in ("session_frames", "warmup_frames", "trace_frames"):
        if c["traffic"][k]:
            c["traffic"][k] = min(c["traffic"][k], 6)
    return c
