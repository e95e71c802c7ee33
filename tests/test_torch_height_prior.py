"""PyTorch port vs JAX package: the metric-scale height prior
(``slam/height_prior.py``) on the same numpy inputs.

The port draws its RANSAC hypotheses from a torch generator, the JAX package
from ``jax.random``; the method is held against JAX by feeding the port the
indices JAX drew (``ransac_plane(..., idx=)``, ``run_points(..., idx=)``):
the plane within 1e-5 and the inlier count equal. ``region_indices`` (a
numpy draw in both) is bitwise. The ports of ``tests/test_aux.py:43``,
``:65``, ``:465`` and ``:483`` run the port on its own draws with the JAX
tests' bars."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.slam import height_prior as jhp
from frodo_slam_tpu_torch.config import make_config as t_make_config
from frodo_slam_tpu_torch.slam import height_prior as thp

torch.set_num_threads(1)


def _ground(h, w, height=0.5, tilt=0.0, noise=0.002, seed=1):
    """Pointmap of a ground plane y = height + tilt * z (camera y down)."""
    rng = np.random.default_rng(seed)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = 2 + vv / 10
    X = np.stack([(uu - w / 2) / 10, height + tilt * z, z], axis=-1)
    return (X + rng.normal(size=X.shape) * noise).astype(np.float32)


def _jax_draw(key, iters, n):
    return np.array(jax.random.randint(key, (iters, 3), 0, n))


@pytest.mark.parametrize("seed,iters,outliers", [(0, 200, 0), (1, 300, 400), (2, 50, 100), (3, 1000, 0)])
def test_ransac_plane_with_jax_indices(seed, iters, outliers):
    rng = np.random.default_rng(seed)
    pts = _ground(24, 32, tilt=0.03 * seed, seed=seed).reshape(-1, 3)
    pts[:outliers] = rng.normal(size=(outliers, 3)).astype(np.float32) * 3.0
    key = jax.random.PRNGKey(seed)
    plane_j, n_j = jhp.ransac_plane(jnp.asarray(pts), key, iterations=iters, inlier_thresh=0.04)
    plane_t, n_t = thp.ransac_plane(torch.from_numpy(pts), iterations=iters, inlier_thresh=0.04,
                                    idx=torch.from_numpy(_jax_draw(key, iters, pts.shape[0])))
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_allclose(plane_t.numpy(), np.asarray(plane_j), atol=1e-5)
    # its own generator: the same plane within the noise
    plane_o, n_o = thp.ransac_plane(torch.from_numpy(pts), torch.Generator().manual_seed(0), iters, 0.04)
    assert int(n_o) >= 0.9 * int(n_j)
    np.testing.assert_allclose(abs(float(plane_o[1])), abs(float(plane_j[1])), atol=0.02)


def test_ransac_plane_degenerate_triples_score_zero():
    pts = torch.zeros((10, 3))
    pts[:, 0] = torch.arange(10.0)  # collinear: every hypothesis degenerate
    _, n = thp.ransac_plane(pts, torch.Generator().manual_seed(0), 20)
    assert int(n) == 0


@pytest.mark.parametrize("hw,corners,sub", [((24, 32), None, 1000), ((32, 64), None, 100),
                                            ((288, 512), None, 1000), ((32, 48), ((40, 31), (8, 20)), 1000),
                                            ((512, 288), ((10, 300), (280, 500)), 1000)])
def test_region_indices_bitwise(hw, corners, sub):
    got = thp.RectanglePlaneEstimator(corners=corners, max_subsample=sub).region_indices(hw)
    want = jhp.RectanglePlaneEstimator(corners=corners, max_subsample=sub).region_indices(hw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(got) <= sub


def test_run_points_with_jax_indices_matches_jax():
    """``run_points``: each call's hypotheses from the next key of the JAX
    estimator's split chain; heights within 1e-5, rejections equal (a
    tilted plane, too few inliers)."""
    h, w = 24, 32
    ts = thp.RectanglePlaneEstimator(corners=((0, 0), (w - 1, h - 1)), min_inliers=50, ransac_iterations=200)
    js = jhp.RectanglePlaneEstimator(corners=((0, 0), (w - 1, h - 1)), min_inliers=50, ransac_iterations=200)
    key = jax.random.PRNGKey(0)
    for X in (_ground(h, w), _ground(h, w, tilt=0.5), _ground(h, w, height=2.0, tilt=0.05, seed=4),
              np.random.default_rng(9).normal(size=(h, w, 3)).astype(np.float32) * 3):
        pts = X.reshape(-1, 3)[ts.region_indices((h, w))]
        key, sub = jax.random.split(key)
        got = ts.run_points(pts, idx=torch.from_numpy(_jax_draw(sub, 200, pts.shape[0])))
        want = js.run_points(pts)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_height_prior_plane():
    """The port of ``tests/test_aux.py:43`` on the port's own draws."""
    h, w = 24, 32
    X = _ground(h, w)
    est = thp.RectanglePlaneEstimator(corners=((0, 0), (w - 1, h - 1)), min_inliers=50, ransac_iterations=200)
    height = est.run(X.reshape(-1, 3), (h, w))
    assert height is not None
    np.testing.assert_allclose(height, 0.5, atol=0.02)
    Xt = X.copy()
    Xt[..., 1] += Xt[..., 2] * 0.5  # ~26 degrees
    assert est.run(Xt.reshape(-1, 3), (h, w)) is None


def test_height_prior_configured_rect():
    """The port of ``tests/test_aux.py:65``: the rectangle gates the fit."""
    h, w = 32, 48
    rng = np.random.default_rng(3)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = 2 + vv / 10
    X = np.stack([(uu - w / 2) / 10, 0.5 + 0.02 * z, z], axis=-1)
    X += rng.normal(size=X.shape) * 0.002
    rect = ((8, 20), (40, 31))
    (x0, y0), (x1, y1) = rect
    outside = np.ones((h, w), bool)
    outside[y0:y1 + 1, x0:x1 + 1] = False
    X[outside] = rng.normal(size=(outside.sum(), 3)) * 3.0
    est = thp.RectanglePlaneEstimator(corners=rect, min_inliers=50, ransac_iterations=300)
    height = est.run(X.reshape(-1, 3), (h, w))
    assert height is not None
    np.testing.assert_allclose(height, 0.5, atol=0.06)
    est_full = thp.RectanglePlaneEstimator(corners=((0, 0), (w - 1, h - 1)), min_inliers=600,
                                           ransac_iterations=300)
    assert est_full.run(X.reshape(-1, 3), (h, w)) is None
    cfg = t_make_config(height_prior={"rect": [[8, 20], [40, 31]]})
    assert list(map(list, cfg.height_prior.rect)) == [[8, 20], [40, 31]]


def test_height_prior_mask_file(tmp_path):
    """The port of ``tests/test_aux.py:465``: both reference pickle formats."""
    rect = np.array([[115, 230], [424, 286]])
    p1 = tmp_path / "rect_mask.pkl"
    with open(p1, "wb") as f:
        pickle.dump(rect, f)
    poly = np.array([[388, 211], [91, 208], [88, 272], [383, 272], [387, 210]])
    p2 = tmp_path / "polygon_mask.pkl"
    with open(p2, "wb") as f:
        pickle.dump(poly, f)
    for p in (p1, p2):
        assert thp.corners_from_mask_file(str(p)) == jhp.corners_from_mask_file(str(p))
    assert thp.corners_from_mask_file(str(p1)) == ((115, 230), (424, 286))
    assert thp.corners_from_mask_file(str(p2)) == ((88, 208), (388, 272))


def test_height_prior_scale_target_is_map_gauge():
    """The port of ``tests/test_aux.py:483``: a ground plane at g *
    camera_height gives the gauge target g (world per metric), not its
    inverse; a rejected fit gives -1."""
    h, w = 24, 32
    camera_height, g = 0.5, 2.0
    X = _ground(h, w, height=g * camera_height, seed=5)
    est = thp.RectanglePlaneEstimator(corners=((0, 0), (w - 1, h - 1)), min_inliers=50, ransac_iterations=200)
    tilted = X.copy()
    tilted[..., 1] += tilted[..., 2] * 0.5
    sb = thp.scale_targets(est, [X.reshape(-1, 3), tilted.reshape(-1, 3)], (h, w), camera_height)
    assert sb.dtype == np.float32
    np.testing.assert_allclose(sb[0], g, atol=0.05)
    assert sb[1] == -1.0
