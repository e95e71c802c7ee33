"""Device time of the kernels launched under the program's model spans (the
cell's architecture's ``MODEL_SPANS``: for MASt3R ``model.encode`` in
``mast3r.encode_image`` and ``model.decode`` in ``mast3r.decode_and_heads``,
wherever they are called from), a frame of the traced slice."""


def read(s):
    t = sum(s["span_device_s"].get(name, 0.0) for name in s["model_spans"])
    if not s["slice_frames"] or t <= 0:
        return None
    return 1e3 * t / s["slice_frames"]
