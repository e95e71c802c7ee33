"""Host waits on the card in the traced slice, a frame: the runtime's
stream, event and device synchronisations (each device-to-host fetch ends
in one), from the profiler's trace."""


def read(s):
    return s["syncs"] / s["slice_frames"] if s["slice_frames"] else None
