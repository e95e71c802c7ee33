"""Median host time of the program's window solve span
(``backend.solve_rays`` or ``backend.solve_calib``, around
``solve_gn_rays`` / ``solve_gn_calib``; the solve ends in a host fetch) in
the traced slice."""

import statistics


def read(s):
    h = s["span_host_s"]
    xs = h.get("backend.solve_rays", []) + h.get("backend.solve_calib", [])
    return 1e3 * statistics.median(xs) if xs else None
