"""PyTorch port vs JAX package: trajectory and map export, ATE.

- ``save_traj``: byte-identical files (the same f-string over the same f32
  values);
- ``save_ply`` / ``save_reconstruction``: the same header and vertex count,
  colours equal, points within 1e-5 (the port's Sim(3) action in torch vs
  the JAX package's, f32);
- ``save_keyframes``: the PNGs decode to the same pixels (PIL vs cv2
  writers, both lossless);
- ``associate``, ``umeyama_sim3`` and ``ate_rmse``: the same numpy f64 code
  on both sides, so equal to 1e-12.
"""

import numpy as np
import PIL.Image
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from frodo_slam_tpu.utils import evaluate as jev  # noqa: E402
from frodo_slam_tpu_torch.ops import lie  # noqa: E402
from frodo_slam_tpu_torch.utils import evaluate as tev  # noqa: E402

torch.set_num_threads(1)


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 7)) * np.array([1.0, 1.0, 1.0, 0.3, 0.3, 0.3, 0.2])
    return lie.sim3_exp(torch.from_numpy(xi)).float().numpy()


def test_save_traj_is_byte_identical(tmp_path):
    poses = _poses(5)
    stamps = ["1305031452.791720", "1305031452.859592", 3.5, 4, "5"]
    a = tev.save_traj(tmp_path / "t", "seq.txt", stamps, poses)
    b = jev.save_traj(tmp_path / "j", "seq.txt", stamps, poses)
    assert a.read_bytes() == b.read_bytes()
    rows = np.loadtxt(a)
    assert rows.shape == (5, 8) and np.isfinite(rows).all()


def _read_ply(path):
    data = path.read_bytes()
    head, body = data.split(b"end_header\n", 1)
    rec = np.frombuffer(body, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    return head, rec


def test_save_reconstruction_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    P, HW = 3, 40
    poses = _poses(P, 1)
    X = rng.normal(size=(P, HW, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    cols = rng.uniform(0, 1, (P, HW, 3)).astype(np.float32)
    C = rng.uniform(0, 3, (P, HW, 1)).astype(np.float32)
    tev.save_reconstruction(tmp_path / "t", "m.ply", poses, X, cols, C)
    jev.save_reconstruction(tmp_path / "j", "m.ply", poses, X, cols, C)
    ht, rt = _read_ply(tmp_path / "t" / "m.ply")
    hj, rj = _read_ply(tmp_path / "j" / "m.ply")
    assert ht == hj and len(rt) == len(rj) == int((C > 1.5).sum()) > 0
    for c in ("red", "green", "blue"):
        np.testing.assert_array_equal(rt[c], rj[c])
    for c in ("x", "y", "z"):
        np.testing.assert_allclose(rt[c], rj[c], atol=1e-5, rtol=1e-6)


def test_save_ply_uint8_colours(tmp_path):
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    cols = np.array([[0, 128, 255]] * 4, np.uint8)
    tev.save_ply(tmp_path / "a.ply", pts, cols)
    jev.save_ply(tmp_path / "b.ply", pts, cols)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_save_keyframes_same_pixels(tmp_path):
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (12, 20, 3), dtype=np.uint8), rng.uniform(0, 1, (12, 20, 3))]
    tev.save_keyframes(tmp_path / "t", [1.5, "2.25"], imgs)
    jev.save_keyframes(tmp_path / "j", [1.5, "2.25"], imgs)
    for name in ("1.5.png", "2.25.png"):
        a = np.asarray(PIL.Image.open(tmp_path / "t" / name).convert("RGB"))
        b = np.asarray(PIL.Image.open(tmp_path / "j" / name).convert("RGB"))
        np.testing.assert_array_equal(a, b)


def _traj_pair(tmp_path, n=40, seed=5):
    """A ground-truth trajectory and an estimate: the truth under a Sim(3)
    (scale 0.37) plus noise, on timestamps a few ms off, every third frame."""
    rng = np.random.default_rng(seed)
    ts = 1000.0 + np.arange(n) / 30.0
    xyz = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    q = np.tile([0, 0, 0, 1.0], (n, 1))
    np.savetxt(tmp_path / "gt.txt", np.c_[ts, xyz, q], header="timestamp tx ty tz qx qy qz qw")
    R = lie.quat_to_R(lie.sim3_exp(torch.tensor([0, 0, 0, 0.3, -0.2, 0.5, 0.0]))[3:7]).numpy()
    est = 0.37 * xyz @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.002, (n, 3))
    sel = np.arange(0, n, 3)
    np.savetxt(tmp_path / "est.txt", np.c_[ts[sel] + 0.004, est[sel], q[sel]])
    return ts, xyz, est


def test_umeyama_and_ate_match_jax(tmp_path):
    ts, xyz, est = _traj_pair(tmp_path)
    for with_scale in (True, False):
        got = tev.umeyama_sim3(est, xyz, with_scale=with_scale)
        want = jev.umeyama_sim3(est, xyz, with_scale=with_scale)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        ate_t = tev.ate_rmse(tmp_path / "gt.txt", tmp_path / "est.txt", with_scale=with_scale)
        ate_j = jev.ate_rmse(tmp_path / "gt.txt", tmp_path / "est.txt", with_scale=with_scale)
        assert ate_t == pytest.approx(ate_j, rel=1e-12, abs=1e-15)
    s, R, t = tev.umeyama_sim3(est, xyz)
    assert s == pytest.approx(1 / 0.37, rel=1e-2)
    assert tev.ate_rmse(tmp_path / "gt.txt", tmp_path / "est.txt") < 0.02  # noise / 0.37 scale


def test_associate_matches_jax():
    rng = np.random.default_rng(6)
    a = np.sort(rng.uniform(0, 10, 50))
    b = np.sort(rng.uniform(0, 10, 80))
    for got, want in zip(tev.associate(a, b, 0.05), jev.associate(a, b, 0.05)):
        np.testing.assert_array_equal(got, want)


def test_ate_needs_three_associations(tmp_path):
    np.savetxt(tmp_path / "a.txt", [[1.0, 0, 0, 0, 0, 0, 0, 1], [2.0, 1, 0, 0, 0, 0, 0, 1]])
    with pytest.raises(ValueError, match="associations"):
        tev.ate_rmse(tmp_path / "a.txt", tmp_path / "a.txt")
