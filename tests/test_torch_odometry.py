"""PyTorch port vs JAX package: the robot VIO path's host modules on the same
numpy inputs. ``slam/odometry.py`` and ``utils/sigma_compute.py`` are numpy
in both packages (the port keeps its own copies), so they are held bitwise;
``slam/imu.py`` preintegrates in f32 (a ``lax.scan`` there, a loop over CPU
tensors here): within 1e-5."""

import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.slam import imu as jimu
from frodo_slam_tpu.slam import odometry as jodo
from frodo_slam_tpu.utils import sigma_compute as jsig
from frodo_slam_tpu_torch.slam import imu as timu
from frodo_slam_tpu_torch.slam import odometry as todo
from frodo_slam_tpu_torch.utils import sigma_compute as tsig

torch.set_num_threads(1)


def test_robot_params_and_constants_equal():
    assert todo.ROBOT_PARAMS == jodo.ROBOT_PARAMS
    for k in ("RPM_EQ_EPS", "MIN_MATCH_ANGLES", "RANSAC_THRESH_RAD", "RANSAC_ITERS"):
        assert getattr(todo, k) == getattr(jodo, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pos_yaw_to_se3_bitwise(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        pos, yaw = rng.normal(size=2) * 3, rng.uniform(-4, 4)
        got, want = todo.pos_yaw_to_se3(pos, yaw), jodo.pos_yaw_to_se3(pos, yaw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(todo.pos_yaw_to_se3((1.0, 2.0), 0.0)[:3], [-2.0, 0.0, 1.0])


@pytest.mark.parametrize("n", [0, 1, 5, 40])
def test_ransac_mode_bitwise(n):
    rng = np.random.default_rng(n)
    angles = list(np.concatenate([rng.normal(0.3, 0.01, n), rng.uniform(-3, 3, n // 3)]))
    assert todo.ransac_mode(angles) == jodo.ransac_mode(angles)
    assert todo.ransac_mode(angles, rng=np.random.default_rng(7)) == jodo.ransac_mode(
        angles, rng=np.random.default_rng(7))
    if n:
        assert todo.bearing_xz(np.asarray([0.3, 0.1, 1.0])) == jodo.bearing_xz(np.asarray([0.3, 0.1, 1.0]))


def _integrate(mod, rows, yaws):
    o = mod.WheelOdometryIntegrator("mini")
    for chunk, yaw in zip(np.array_split(np.asarray(rows), len(yaws)), yaws):
        o.integrate_rpms([tuple(r) for r in chunk])
        o.apply_yaw(yaw)
    return o.x, o.y, o.th, list(o.path), o.pose_se3()


def test_wheel_odometry_straight_and_spin_matches_jax():
    """The port of ``tests/test_aux.py:271`` (straight, spin, yaw offset),
    then a seeded mixed drive: every state bitwise."""
    o = todo.WheelOdometryIntegrator("mini")
    o.integrate_rpms([(60.0, 60.0, 60.0, 60.0, t) for t in np.linspace(0, 1, 11)])
    np.testing.assert_allclose(o.x, math.pi * 0.095, rtol=1e-6)
    assert o.y == 0.0
    o2 = todo.WheelOdometryIntegrator("mini")
    o2.integrate_rpms([(30.0, -30.0, 30.0, -30.0, t) for t in np.linspace(0, 1, 11)])
    assert o2.x == 0.0 and o2.y == 0.0
    o3 = todo.WheelOdometryIntegrator("mini")
    o3.apply_yaw(math.pi / 2)
    np.testing.assert_allclose(o3.x, 0.075 * (math.cos(math.pi / 2) - 1), atol=1e-9)
    np.testing.assert_allclose(o3.y, 0.075, atol=1e-9)

    rng = np.random.default_rng(3)
    ts = np.cumsum(rng.uniform(0.01, 0.1, 120))
    left = rng.choice([60.0, 62.0, -40.0, 0.0], 120)
    right = left + rng.choice([0.0, 3.0, 80.0], 120)
    rows = np.stack([left, right, left, right, ts], -1)
    rows[50, 4] = rows[49, 4]  # a repeated timestamp is skipped
    yaws = rng.uniform(-0.3, 0.3, 6)
    got, want = _integrate(todo, rows, yaws), _integrate(jodo, rows, yaws)
    assert got[:4] == want[:4]
    np.testing.assert_array_equal(got[4], want[4])


def test_odometry_data_replay_matches_jax(tmp_path):
    """``OdometryData`` (the pickle replay run_vio reads): indexed pacing,
    odometry on and off, the robot type from the file name."""
    rng = np.random.default_rng(0)
    items = [{"timestamp": 0.1 * i, "frame": rng.integers(0, 255, (4, 6, 3), np.uint8),
              "pose": np.asarray([0.05 * i, 0, 0, 0, 0, 0, 1], np.float32)} for i in range(5)]
    p = tmp_path / "session_zero.pkl"
    with open(p, "wb") as f:
        pickle.dump(items, f)
    assert todo.replay_odometry(str(p))[3]["timestamp"] == jodo.replay_odometry(str(p))[3]["timestamp"]
    for use_odom in (False, True):
        dt, dj = todo.OdometryData(str(p), use_odometry=use_odom), jodo.OdometryData(str(p), use_odometry=use_odom)
        assert dt.robot_type == dj.robot_type == "zero" and len(dt) == len(dj) == 5
        while True:
            (tt, ft, pt), (tj, fj, pj) = dt.get_frame_and_pose(), dj.get_frame_and_pose()
            assert tt == tj
            if ft is None:
                assert fj is None and pt is None and pj is None
                break
            np.testing.assert_array_equal(ft, fj)
            if use_odom:
                np.testing.assert_array_equal(pt, pj)
            else:
                assert pt is None and pj is None
    wall = todo.OdometryData(str(p), wall_clock=True)
    assert wall.get_frame_and_pose()[0] == 0.0


def test_imu_preintegration_matches_jax():
    """The port of ``tests/test_aux.py:300`` (static calibration, then 1 m/s^2
    along z for 1 s), then a seeded rotating batch: within 1e-5."""
    pre_t, pre_j = timu.IMUPreintegrator(9.81), jimu.IMUPreintegrator(9.81)
    gyro = np.zeros((50, 3)) + 0.01
    accel = np.tile(np.array([0.0, 9.81, 0.0]), (50, 1))
    pre_t.calibrate_static(gyro, accel)
    pre_j.calibrate_static(gyro, accel)
    np.testing.assert_allclose(pre_t.bias_g, 0.01, atol=1e-6)
    for a in ("bias_g", "bias_a"):
        np.testing.assert_allclose(getattr(pre_t, a), getattr(pre_j, a), atol=1e-6)
    np.testing.assert_allclose(pre_t.state.q, np.asarray(pre_j.state.q), atol=1e-6)

    n = 100
    dts = np.full(n, 0.01)
    gyro = np.tile(pre_t.bias_g, (n, 1))
    accel = np.tile(np.array([0.0, 9.81, 1.0]), (n, 1)) + pre_t.bias_a
    st, sj = pre_t.update(gyro, accel, dts), pre_j.update(gyro, accel, dts)
    np.testing.assert_allclose(st.v, [0, 0, 1.0], atol=5e-3)
    np.testing.assert_allclose(st.p, [0, 0, 0.5], atol=5e-3)

    rng = np.random.default_rng(4)
    gyro = rng.normal(size=(60, 3)) * 0.5
    accel = rng.normal(size=(60, 3)) + [0.0, 9.81, 0.0]
    dts = rng.uniform(0.005, 0.02, 60)
    st, sj = pre_t.update(gyro, accel, dts), pre_j.update(gyro, accel, dts)
    for a in ("q", "v", "p"):
        np.testing.assert_allclose(getattr(st, a), np.asarray(getattr(sj, a)), atol=1e-5, err_msg=a)
    assert st.t == sj.t
    args = [rng.normal(size=s).astype(np.float32) for s in ((4,), (3,), (3,), (7, 3), (7, 3), (7,), (3,), (3,), (3,))]
    args[0] /= np.linalg.norm(args[0])
    got = timu.preintegrate(*map(torch.from_numpy, args))
    want = jimu.preintegrate(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("pair", [((0, 0, 1.0), (0, 1.0, 0)), ((1.0, 0, 0), (-1.0, 0, 0)),
                                  ((0.3, -0.2, 0.9), (0.1, 0.8, -0.4)), ((0, 1.0, 0), (0, 2.0, 0))])
def test_rotation_aligning_bitwise(pair):
    a, b = (np.asarray(v) for v in pair)
    np.testing.assert_array_equal(timu.rotation_aligning(a, b), jimu.rotation_aligning(a, b))


def test_compute_sigmas_bitwise(tmp_path, capsys):
    rng = np.random.default_rng(5)
    for shape in ((50, 6), (20, 3), (9, 7)):
        res = rng.normal(size=shape) * [1e-3] * shape[1]
        got, want = tsig.compute_sigmas(res), jsig.compute_sigmas(res)
        np.testing.assert_array_equal(got["per_column_std"], want["per_column_std"])
        assert got["sigma_odom_t"] == want["sigma_odom_t"]
        assert got["sigma_odom_r"] == want["sigma_odom_r"]
    f = tmp_path / "res.txt"
    np.savetxt(f, rng.normal(size=(30, 6)))
    tsig.main(str(f))
    out_t = capsys.readouterr().out
    jsig.main(str(f))
    assert out_t == capsys.readouterr().out and "sigma_odom_r" in out_t
