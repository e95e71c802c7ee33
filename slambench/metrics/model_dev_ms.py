"""Device time of the kernels launched under the program's model spans
(``model.encode`` in ``mast3r.encode_image``, ``model.decode`` in
``mast3r.decode_and_heads``, wherever they are called from), a frame of
the traced slice."""


def read(s):
    t = s["span_device_s"].get("model.encode", 0.0) + s["span_device_s"].get("model.decode", 0.0)
    if not s["slice_frames"] or t <= 0:
        return None
    return 1e3 * t / s["slice_frames"]
