"""Kernels launched on the card in the traced slice, a frame."""


def read(s):
    return s["launches"] / s["slice_frames"] if s["slice_frames"] else None
