"""Trajectory/reconstruction export + ATE evaluation.

Spec: ``mast3r_slam/evaluate.py`` — ``save_traj`` TUM format of keyframe
poses with scale dropped (:23-44), ``save_reconstruction`` confidence-
thresholded colored point cloud (:47-70), ``save_ply`` (:88-106),
``save_keyframes`` (:73-85). The port's copy of the JAX package's
``utils/evaluate.py``: the point cloud goes through the port's ``lie`` and
the keyframe PNGs through PIL.

The reference relies on the external ``evo_ape ... -as`` tool for ATE
(scripts/eval_tum.sh:46-52); that package is not in this image, so
:func:`ate_rmse` implements the same metric natively: associate by
timestamp, Umeyama Sim(3) alignment, RMSE of translation residuals.
"""

from __future__ import annotations

import pathlib
from typing import Sequence

import numpy as np
import PIL.Image
import torch

from ..ops import lie


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def save_traj(logdir, logfile, timestamps, poses_sim3: np.ndarray) -> pathlib.Path:
    """TUM-format trajectory: ``t tx ty tz qx qy qz qw`` (evaluate.py:23-44).

    ``poses_sim3``: (N, 8) keyframe T_WC; scale is dropped (Sim3 -> SE3).
    """
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    out = logdir / logfile
    with open(out, "w") as f:
        for ts, P in zip(timestamps, np.asarray(poses_sim3)):
            t, q = P[:3], P[3:7]
            f.write(
                f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )
    return out


def save_ply(filename, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary little-endian PLY of xyz+rgb (evaluate.py:88-106; plyfile is
    not in this image, so write the format directly)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    n = len(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    rec["x"], rec["y"], rec["z"] = points.T
    rec["red"], rec["green"], rec["blue"] = colors.T
    path = pathlib.Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def save_reconstruction(savedir, filename, poses_sim3, pointmaps, colors, confs,
                        conf_threshold: float = 1.5) -> None:
    """World-frame point cloud of all keyframes above the confidence
    threshold (evaluate.py:47-70)."""
    T = torch.as_tensor(np.asarray(poses_sim3, np.float32))[:, None, :]
    pts_w = lie.sim3_act(T, torch.as_tensor(np.asarray(pointmaps, np.float32)))
    pts_w = pts_w.numpy().reshape(-1, 3)
    cols = np.asarray(colors).reshape(-1, 3)
    mask = np.asarray(confs).reshape(-1) > conf_threshold
    save_ply(pathlib.Path(savedir) / filename, pts_w[mask], cols[mask])


def save_keyframes(savedir, timestamps, images: Sequence[np.ndarray]) -> None:
    """Keyframe PNG dump (evaluate.py:73-85), RGB uint8."""
    savedir = pathlib.Path(savedir)
    savedir.mkdir(parents=True, exist_ok=True)
    for ts, img in zip(timestamps, images):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr).save(savedir / f"{ts}.png")


# ---------------------------------------------------------------------------
# ATE (evo_ape tum <gt> <traj> -as equivalent)
# ---------------------------------------------------------------------------

def load_tum_traj(path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps (N,), xyz (N,3)) from a TUM-format file."""
    # ndmin: np.loadtxt squeezes a single-pose file to 1-D (a short map
    # after a tracking-loss reset is legitimate output, not an error)
    data = np.loadtxt(path, comments="#", ndmin=2)
    return data[:, 0], data[:, 1:4]


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association (the evo/TUM default protocol)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, bestdt = None, max_dt
        for cand in (j - 1, j):
            if 0 <= cand < len(ts_b):
                dt = abs(ts_b[cand] - t)
                if dt <= bestdt:
                    best, bestdt = cand, dt
        if best is not None:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_sim3(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares Sim(3) aligning ``src`` onto ``dst`` (Umeyama 1991),
    the '-as' alignment of evo_ape. ``with_scale=False`` fixes s=1 (SE(3)
    alignment, evo_ape '-a'): used to verify METRIC scale recovery — a
    trajectory is metric iff it aligns well WITHOUT the scale freedom.
    Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    if not with_scale or var_s < 1e-12:  # SE(3) mode or degenerate
        s = 1.0
    else:
        s = np.trace(np.diag(D) @ S) / var_s
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(gt_file, traj_file, max_dt: float = 0.02,
             with_scale: bool = True) -> float:
    """Sim(3)-aligned absolute trajectory error RMSE in meters
    (``with_scale=False``: SE(3) alignment — metric-scale check)."""
    ts_gt, xyz_gt = load_tum_traj(gt_file)
    ts_tr, xyz_tr = load_tum_traj(traj_file)
    ia, ib = associate(ts_tr, ts_gt, max_dt)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} associations between trajectories")
    src = xyz_tr[ia]
    dst = xyz_gt[ib]
    s, R, t = umeyama_sim3(src, dst, with_scale=with_scale)
    aligned = (s * (R @ src.T)).T + t
    err = np.linalg.norm(aligned - dst, axis=1)
    return float(np.sqrt((err**2).mean()))
