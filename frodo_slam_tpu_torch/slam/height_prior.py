"""Metric-scale height prior: RANSAC ground-plane fit on an image rectangle.

Behavioral spec: ``mast3r_slam/height_prior.py`` ``RectanglePlaneEstimator``
(:8-166): gather the pointmap inside a fixed image rectangle, subsample,
RANSAC plane fit, reject if the plane normal tilts more than
``max_tilt_deg`` from the camera y-axis or has too few inliers, else return
the ground height ``-d / b``. The backend turns it into a per-keyframe scale
target (global_opt.py:212-224), with the JAX package's gauge convention
(see :func:`scale_targets`). The JAX package's ``slam/height_prior.py`` is
the reference of this port.

All ``ransac_iterations`` hypotheses are evaluated at once: sample triples,
the 3-point plane in closed form, inliers counted over one (iters, N)
distance matrix. The hypotheses are drawn from a ``torch.Generator`` on the
CPU seeded with the estimator's ``seed`` (the JAX package draws them with
``jax.random``; the draws differ, the method does not), so the same rows
give the same fit on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def ransac_plane(pts: torch.Tensor, generator: Optional[torch.Generator] = None, iterations: int = 1000,
                 inlier_thresh: float = 0.04, idx: Optional[torch.Tensor] = None):
    """Fully vectorized 3-point RANSAC plane fit on ``pts.device``.

    pts: (N, 3). ``idx``: optional (iterations, 3) sample indices (a test
    feeds the ones the JAX package drew); else drawn from ``generator`` on
    the CPU. Returns (plane (4,) [a, b, c, d] with unit normal, n_inliers
    0-d int tensor)."""
    n = pts.shape[0]
    if idx is None:
        idx = torch.randint(0, n, (iterations, 3), generator=generator)
    idx = torch.as_tensor(idx).to(pts.device).long()
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    normal = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)  # (it, 3)
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.clamp(norm, min=1e-12)
    d = -torch.sum(normal * p0, dim=-1)  # (it,)

    dist = torch.abs(pts @ normal.T + d[None, :]).T  # (it, N)
    inliers = torch.sum(dist < inlier_thresh, dim=-1)
    inliers = torch.where(norm[:, 0] < 1e-9, 0, inliers)  # degenerate triples

    best = torch.argmax(inliers)
    return torch.cat([normal[best], d[best, None]]), inliers[best]


def corners_from_mask_file(path: str) -> Tuple:
    """Load the reference's pickled ground-region selection
    (config/rect_mask.pkl: a (2, 2) [[x0, y0], [x1, y1]] array;
    config/polygon_mask.pkl: an (N, 2) vertex polygon, reduced to its
    bounding box — the estimator's region is rectangular)."""
    import pickle

    with open(path, "rb") as f:
        arr = np.asarray(pickle.load(f))
    if arr.shape == (2, 2):
        (x0, y0), (x1, y1) = arr
    else:  # polygon vertices
        x0, y0 = arr.min(axis=0)
        x1, y1 = arr.max(axis=0)
    return ((int(x0), int(y0)), (int(x1), int(y1)))


class RectanglePlaneEstimator:
    """Headless equivalent of the reference estimator.

    ``corners``: ((x0, y0), (x1, y1)) pixel rectangle; default the
    bottom-center band of the image (the reference loads an interactively
    picked pickle, height_prior.py:36-43)."""

    def __init__(self, corners: Optional[Tuple] = None, max_subsample: int = 1000,
                 max_tilt_deg: float = 5.0, inlier_thresh: float = 0.04,
                 ransac_iterations: int = 1000, min_inliers: int = 100, seed: int = 0):
        self.corners = corners
        self.max_subsample = max_subsample
        self.max_tilt = np.deg2rad(max_tilt_deg)
        self.inlier_thresh = inlier_thresh
        self.ransac_iterations = ransac_iterations
        self.min_inliers = min_inliers
        self._gen = torch.Generator().manual_seed(seed)

    def default_corners(self, h: int, w: int):
        # bottom-center band: the region most likely to be ground for a
        # forward-looking robot camera
        return ((w // 4, (2 * h) // 3), ((3 * w) // 4, h - 1))

    def region_indices(self, image_size: Tuple[int, int]) -> np.ndarray:
        """Flat row indices (row-major over ``image_size``) of the
        (subsampled) fit region, so that a caller holding pointmaps on the
        card gathers and fetches only these rows. The subsample is the JAX
        package's ``np.random.default_rng(0)`` choice, bitwise."""
        h, w = image_size
        corners = self.corners or self.default_corners(h, w)
        (x0, y0), (x1, y1) = corners
        x_min, x_max = sorted((int(x0), int(x1)))
        y_min, y_max = sorted((int(y0), int(y1)))

        xs = np.arange(x_min, x_max + 1)
        ys = np.arange(y_min, y_max + 1)
        Xs, Ys = np.meshgrid(xs, ys)
        flat_idx = Ys.ravel() * w + Xs.ravel()
        if flat_idx.shape[0] > self.max_subsample:
            choice = np.random.default_rng(0).choice(flat_idx.shape[0], self.max_subsample, replace=False)
            flat_idx = flat_idx[choice]
        return flat_idx

    def run(self, pointmap, image_size: Tuple[int, int]) -> Optional[float]:
        """pointmap: (H*W, 3) camera-frame points. Returns the ground height
        or None (height_prior.py:45-139)."""
        pts = np.asarray(pointmap)[self.region_indices(image_size)]
        return self.run_points(pts)

    def run_points(self, pts, idx: Optional[torch.Tensor] = None) -> Optional[float]:
        """RANSAC + tilt/inlier gates on pre-gathered region points (array or
        tensor; the fit runs where they lie). ``idx``: optional sample
        indices (see :func:`ransac_plane`)."""
        pts = torch.as_tensor(pts).to(torch.float32)
        plane, n_inliers = ransac_plane(pts, self._gen, self.ransac_iterations, self.inlier_thresh, idx)
        vals = torch.cat([plane.double(), n_inliers.double()[None]]).cpu().numpy()  # one fetch
        if int(vals[4]) < self.min_inliers:
            return None
        a, b, c, d = (float(v) for v in vals[:4])
        tilt = np.arccos(min(abs(b), 1.0))  # unit normal: |b| = cos(tilt to the y-axis)
        if tilt > self.max_tilt or abs(b) <= 1e-6:
            return None
        return -d / b


def scale_targets(estimator: RectanglePlaneEstimator, pointmaps, image_size,
                  camera_height: float) -> np.ndarray:
    """Per-keyframe scale-prior targets s_bar = h_bar / camera_height; -1
    where the plane fit is rejected (global_opt.py:212-224).

    Convention (the JAX package's deliberate divergence from the reference,
    which computes ``camera_height / h_bar``): the Sim(3) scale channel is
    the map GAUGE g = world units per metric unit, the convention of the BA
    odometry residual (``t_pred = (1/s_j) ...``; see
    :func:`..slam.pgo.apply_pgo_scale_`). The canonical pointmap measures
    the ground at h_bar = g * camera_height, so the gauge target the scale
    prior ``r = log(s_i / s_bar_i)`` pulls toward is ``h_bar /
    camera_height``. The reference's inverse feeds the same solve as its
    odometry factors; the two fight at any gauge other than 1."""
    out = []
    for X in pointmaps:
        h_bar = estimator.run(X, image_size)
        out.append(h_bar / camera_height if h_bar is not None and h_bar > 1e-6 else -1.0)
    return np.asarray(out, np.float32)
