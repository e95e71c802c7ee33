"""Wheel + visual odometry for the robot VIO mode.

Behavioral spec: ``mast3r_slam/odometry.py`` — the straight-or-spin motion
model (:340-359: integrate wheel RPM only when both sides agree in sign and
magnitude), optical yaw from ray-table bearings with 1-D RANSAC
(:243-279, ``ransac_mode`` :62-80), camera forward-offset compensation
(:326-338), robot geometry constants (:103-129), ``pos_yaw_to_se3``
(:82-100), and the pickle record/replay path (:528-680).

The port's own copy of the JAX package's ``slam/odometry.py`` (pure numpy
there and here), split into:
- :class:`WheelOdometryIntegrator` — the pure motion model (testable, no IO);
- :class:`OdometryData` — recorded-session replay (the ``run_vio`` dataset
  path);
- :class:`StraightOrSpinOdometry` — the live robot poller (HTTP polling +
  ORB yaw), import-gated on ``requests``/``cv2`` and untested (hardware).
"""

from __future__ import annotations

import math
import os
import pickle
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np


# -- robot geometry (odometry.py:103-129) -----------------------------------

ROBOT_PARAMS = {
    "mini": dict(wheel_diam_m=0.095, track_m=0.160, camera_offset_m=0.075, camera_height=0.148),
    "zero": dict(wheel_diam_m=0.13, track_m=0.2, camera_offset_m=0.06, camera_height=0.561),
}

RPM_EQ_EPS = 5
MIN_MATCH_ANGLES = 15
RANSAC_THRESH_RAD = 0.05
RANSAC_ITERS = 150


def pos_yaw_to_se3(pos, yaw) -> np.ndarray:
    """(x, y) planar position + yaw -> SE3 7-vector [t, q]
    (odometry.py:82-100): rotation about the camera y-axis by -yaw, with the
    planar frame mapped as z <- x, x <- -y."""
    half = -0.5 * float(yaw)
    q = np.array([0.0, math.sin(half), 0.0, math.cos(half)], np.float32)
    t = np.array([-float(pos[1]), 0.0, float(pos[0])], np.float32)
    return np.concatenate([t, q])


def ransac_mode(angles: List[float], iters: int = RANSAC_ITERS,
                thresh_rad: float = RANSAC_THRESH_RAD, rng=None) -> Optional[float]:
    """1-D RANSAC: the hypothesis with most inliers, refined as the inlier
    median (odometry.py:62-80)."""
    if not angles:
        return None
    a = np.asarray(angles)
    rng = np.random.default_rng(0) if rng is None else rng
    picks = rng.integers(0, len(a), size=min(iters, len(a) * 4))
    best_inl, best = -1, None
    for p in picks:
        inl = np.abs(a - a[p]) < thresh_rad
        n = int(inl.sum())
        if n > best_inl:
            best_inl, best = n, float(np.median(a[inl]))
    return best


def bearing_xz(v: np.ndarray) -> float:
    """Bearing of a camera ray projected to the x-z plane."""
    return math.atan2(v[0], v[2])


class WheelOdometryIntegrator:
    """Straight-or-spin dead reckoning (odometry.py:326-359).

    Translation comes only from wheel RPM when the robot drives straight
    (both sides same sign, |difference| <= RPM_EQ_EPS); heading comes from
    the vision yaw estimate, with the camera's forward offset folded into
    the position update.
    """

    def __init__(self, robot_type: str = "mini"):
        p = ROBOT_PARAMS[robot_type]
        self.circ_m = math.pi * p["wheel_diam_m"]
        self.camera_offset_m = p["camera_offset_m"]
        self.camera_height = p["camera_height"]
        self.x = self.y = self.th = 0.0
        self.prev_ts: Optional[float] = None
        self.path: deque = deque([(0.0, 0.0)], maxlen=2000)

    def _rpm_to_mps(self, rpm: float) -> float:
        return rpm / 60.0 * self.circ_m

    def apply_yaw(self, dth: float):
        """Vision yaw update + camera-offset compensation
        (odometry.py:326-338)."""
        old_th = self.th
        new_th = self._wrap(old_th + dth)
        r = self.camera_offset_m
        self.x += r * (math.cos(new_th) - math.cos(old_th))
        self.y += r * (math.sin(new_th) - math.sin(old_th))
        self.th = new_th
        self.path.append((self.x, self.y))

    def integrate_rpms(self, rpm_rows: List[Tuple[float, float, float, float, float]]):
        """Rows (r1, r2, r3, r4, ts), sorted by ts (odometry.py:340-359)."""
        for r1, r2, r3, r4, ts in rpm_rows:
            if self.prev_ts is not None and ts <= self.prev_ts:
                continue
            dt = 0.0 if self.prev_ts is None else ts - self.prev_ts
            self.prev_ts = ts
            rpm_l, rpm_r = 0.5 * (r1 + r3), 0.5 * (r2 + r4)
            straight = (rpm_l * rpm_r) > 0 and abs(rpm_l - rpm_r) <= RPM_EQ_EPS
            if straight:
                v = self._rpm_to_mps(rpm_l)
                self.x += v * math.cos(self.th) * dt
                self.y += v * math.sin(self.th) * dt
                self.path.append((self.x, self.y))

    def pose_se3(self) -> np.ndarray:
        return pos_yaw_to_se3((self.x, self.y), self.th)

    @staticmethod
    def _wrap(a: float) -> float:
        return (a + math.pi) % (2 * math.pi) - math.pi


def yaw_from_rays(prev_gray, cur_gray, dirs: Dict[str, np.ndarray],
                  orb_levels=(200, 1000, 2000, 5000)) -> Optional[float]:
    """ORB match -> per-match ray-bearing deltas -> RANSAC mode
    (odometry.py:243-279). ``dirs`` maps "x,y" pixel keys to unit rays."""
    import cv2

    for nfeat in orb_levels:
        orb = cv2.ORB_create(nfeatures=nfeat)
        k0, d0 = orb.detectAndCompute(prev_gray, None)
        k1, d1 = orb.detectAndCompute(cur_gray, None)
        if d0 is None or d1 is None:
            continue
        bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        matches = sorted(bf.match(d0, d1), key=lambda m: m.distance)
        if len(matches) < MIN_MATCH_ANGLES:
            continue
        angles: List[float] = []
        for m in matches:
            x0, y0 = map(int, map(round, k0[m.queryIdx].pt))
            x1, y1 = map(int, map(round, k1[m.trainIdx].pt))
            key0, key1 = f"{x0},{y0}", f"{x1},{y1}"
            if key0 in dirs and key1 in dirs:
                a = WheelOdometryIntegrator._wrap(
                    bearing_xz(np.asarray(dirs[key1])) - bearing_xz(np.asarray(dirs[key0]))
                )
                if not math.isnan(a):
                    angles.append(a)
            if len(angles) >= MIN_MATCH_ANGLES:
                break
        if len(angles) < 3:
            continue
        best = ransac_mode(angles)
        return best if best is not None else float(np.median(angles))
    return None


# -- record / replay (odometry.py:528-680) -----------------------------------

def record_odometry(data_path: str, duration_s: float = 60.0, poll_s: float = 0.1,
                    robot_type: str = "mini"):  # pragma: no cover - hardware
    data_path = data_path + f"_{robot_type}.pkl"
    odo = StraightOrSpinOdometry(robot_type=robot_type)
    odo.start()
    try:
        data, last_frame = [], None
        start = time.time()
        while time.time() - start < duration_s:
            ts, frame, pose = odo.get_frame_and_pose()
            if frame is None:
                continue
            if last_frame is None or not np.array_equal(frame, last_frame):
                data.append({"timestamp": ts, "frame": frame, "pose": pose})
                last_frame = frame.copy()
            time.sleep(poll_s)
        os.makedirs(os.path.dirname(data_path), exist_ok=True)
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
    finally:
        odo.stop()


def replay_odometry(data_path: str) -> List[dict]:
    with open(data_path, "rb") as f:
        return pickle.load(f)


class OdometryData:
    """Recorded-session replay (odometry.py:604-680): indexed or wall-clock
    pacing; robot type parsed from the filename suffix."""

    def __init__(self, data_path: str, wall_clock: bool = False, use_odometry: bool = False, **kw):
        self.data = replay_odometry(data_path)
        self.wall_clock = wall_clock
        self.use_odometry = use_odometry
        self.last_real_time = None
        self.last_data_time = None
        self.current_idx = 0
        self.idx = 0
        self.robot_type = data_path.split("_")[-1].split(".")[0]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]

    def _emit(self, item):
        pose = item["pose"] if self.use_odometry else None
        return item["timestamp"], item["frame"], pose

    def get_frame_and_pose(self):
        if not self.wall_clock:
            if self.idx >= len(self.data):
                return None, None, None
            item = self.data[self.idx]
            self.idx += 1
            return self._emit(item)

        now = time.time()
        if self.last_real_time is None:
            self.last_real_time = now
            self.last_data_time = self.data[0]["timestamp"]
            self.current_idx = 0
            return self._emit(self.data[0])
        target = self.last_data_time + (now - self.last_real_time)
        while self.current_idx < len(self.data) - 1:
            self.current_idx += 1
            if self.data[self.current_idx]["timestamp"] > target:
                break
        self.last_real_time = now
        self.last_data_time = self.data[self.current_idx]["timestamp"]
        return self._emit(self.data[self.current_idx])


class StraightOrSpinOdometry:  # pragma: no cover - hardware
    """Live robot odometry: poll wheel RPM + camera REST APIs, fuse with the
    straight-or-spin model (odometry.py:118-526). Requires ``requests``."""

    def __init__(self, robot_type: str = "mini",
                 rpm_api: str = "http://localhost:8000/data",
                 cam_api: str = "http://localhost:8000/v2/front",
                 poll_s: float = 0.1, timeout_s: float = 2.0,
                 directions: Optional[Dict[str, np.ndarray]] = None):
        import threading

        self.integrator = WheelOdometryIntegrator(robot_type)
        self._rpm_api, self._cam_api = rpm_api, cam_api
        self._poll_s, self._timeout = poll_s, timeout_s
        self._dirs = directions or {}
        self._prev_frame = None
        self._frame = None
        self._ts = None
        self._running = False
        self._lock = threading.Lock()
        self._thread = None

    def start(self):
        import threading

        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def get_frame_and_pose(self):
        with self._lock:
            pose = pos_yaw_to_se3((self.integrator.x, self.integrator.y), self.integrator.th)
            return self._ts, self._frame, pose

    def _loop(self):
        import base64

        import cv2
        import requests

        while self._running:
            try:
                rpm_rows = requests.get(self._rpm_api, timeout=self._timeout).json().get("rpms", [])
                rpm_rows.sort(key=lambda r: r[4])
            except Exception:
                continue
            try:
                b64 = requests.get(self._cam_api, timeout=self._timeout).json().get("front_frame", "")
                frame = (
                    cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8), cv2.IMREAD_COLOR)
                    if b64 else None
                )
            except Exception:
                continue

            if frame is not None and self._prev_frame is not None and self._dirs:
                g0 = cv2.cvtColor(self._prev_frame, cv2.COLOR_BGR2GRAY)
                g1 = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                dth = yaw_from_rays(g0, g1, self._dirs)
                if dth is not None:
                    with self._lock:
                        self.integrator.apply_yaw(dth)
            with self._lock:
                self.integrator.integrate_rpms(rpm_rows)
                if frame is not None:
                    self._prev_frame = frame
                    self._frame = frame
                    self._ts = time.time()
            time.sleep(self._poll_s)
