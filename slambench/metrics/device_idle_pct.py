"""Share of the traced slice in which nothing ran on the card: 100 (1 -
busy / window), busy the union of every kernel, copy and set on the
device timeline of the profiler's trace."""


def read(s):
    if s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
