"""Offline sigma calibration utility.

Spec: ``mast3r_slam/sigma_compute.py:1-36`` — compute the standard deviation
of logged odometry residual columns to pick ``sigma_odom_t`` /
``sigma_odom_r`` for the backend. The port's own copy of the JAX package's
``utils/sigma_compute.py``.

Usage: ``python -m frodo_slam_tpu_torch.utils.sigma_compute <residuals.txt>``
where the file has one residual row per line (whitespace-separated; the
translation columns first, rotation columns after).
"""

from __future__ import annotations

import sys

import numpy as np


def compute_sigmas(residuals: np.ndarray, n_trans: int = 3) -> dict:
    """Column std-devs split into translation / rotation groups."""
    residuals = np.atleast_2d(np.asarray(residuals, np.float64))
    stds = residuals.std(axis=0, ddof=1)
    return {
        "per_column_std": stds,
        "sigma_odom_t": float(stds[:n_trans].mean()),
        "sigma_odom_r": float(stds[n_trans:].mean()) if residuals.shape[1] > n_trans else None,
    }


def main(path: str):
    data = np.loadtxt(path)
    out = compute_sigmas(data)
    print("per-column std:", np.array2string(out["per_column_std"], precision=6))
    print(f"sigma_odom_t = {out['sigma_odom_t']:.6f}")
    if out["sigma_odom_r"] is not None:
        print(f"sigma_odom_r = {out['sigma_odom_r']:.6f}")


if __name__ == "__main__":
    main(sys.argv[1])
