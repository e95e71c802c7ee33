"""IMU preintegration (standalone module, as in the reference).

Behavioral spec: ``mast3r_slam/imu.py`` — ``RealTimeIMUIntegrator``
(:94-589): static calibration of gyro/accel biases and a gravity-aligned
initial rotation via the Rodrigues double-vector construction (:22-92,
:167-277), then batched preintegration of (gyro, accel) samples
(:327-428). Like the reference, nothing else imports it. The JAX package's
``slam/imu.py`` is the reference of this port.

Preintegration is the on-manifold recursion, one step per sample:
    R_{k+1} = R_k Exp((w_k - b_g) dt)
    v_{k+1} = v_k + (R_k (a_k - b_a) + g) dt
    p_{k+1} = p_k + v_k dt + 0.5 (R_k (a_k - b_a) + g) dt^2
a Python loop over CPU tensors (the JAX package's ``lax.scan``): a polling
batch holds tens of samples and the path is not the card's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import lie


def rotation_aligning(v_from: np.ndarray, v_to: np.ndarray) -> np.ndarray:
    """Rotation matrix sending unit vector ``v_from`` to ``v_to`` (the
    Rodrigues construction of imu.py:22-92)."""
    a = v_from / np.linalg.norm(v_from)
    b = v_to / np.linalg.norm(v_to)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 / (1.0 + c))


def preintegrate(q0, v0, p0, gyro, accel, dts, bias_g, bias_a, gravity):
    """Integrate a batch of IMU samples (imu.py:327-428).

    q0 (4,) scalar-last world-from-body rotation; gyro/accel (N, 3); dts
    (N,); tensors. Returns (q, v, p) after the batch."""
    q, v, p = q0, v0, p0
    for w, a, dt in zip(gyro, accel, dts):
        a_w = lie.quat_act(q, a - bias_a) + gravity
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        q = lie.quat_mul(q, lie.so3_exp((w - bias_g) * dt))
        q = q / torch.linalg.norm(q)
    return q, v, p


@dataclasses.dataclass
class IMUState:
    q: np.ndarray  # (4,) scalar-last
    v: np.ndarray  # (3,)
    p: np.ndarray  # (3,)
    t: float


class IMUPreintegrator:
    """Host wrapper holding biases, gravity and the integrated state."""

    def __init__(self, gravity_mag: float = 9.81):
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)
        self.gravity = np.array([0.0, -gravity_mag, 0.0], np.float32)
        self.state = IMUState(np.array([0, 0, 0, 1], np.float32), np.zeros(3, np.float32),
                              np.zeros(3, np.float32), 0.0)

    def calibrate_static(self, gyro: np.ndarray, accel: np.ndarray):
        """Static-pose calibration (imu.py:167-277): gyro bias = mean rate;
        the initial rotation aligns the mean specific force with -gravity;
        accel bias = the residual in the aligned frame."""
        self.bias_g = gyro.mean(0).astype(np.float32)
        mean_acc = accel.mean(0)
        R0 = rotation_aligning(mean_acc / np.linalg.norm(mean_acc),
                               -self.gravity / np.linalg.norm(self.gravity))
        q0 = lie.R_to_quat(torch.as_tensor(R0, dtype=torch.float32))
        self.state.q = q0.numpy().astype(np.float32)
        # accel bias in the body frame: what remains after gravity compensation
        g_body = lie.quat_act(lie.quat_inv(q0), torch.as_tensor(-self.gravity)).numpy()
        self.bias_a = (mean_acc - g_body).astype(np.float32)

    def update(self, gyro: np.ndarray, accel: np.ndarray, dts: np.ndarray) -> IMUState:
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
        q, v, p = preintegrate(f32(self.state.q), f32(self.state.v), f32(self.state.p),
                               f32(gyro), f32(accel), f32(dts),
                               f32(self.bias_g), f32(self.bias_a), f32(self.gravity))
        self.state = IMUState(q.numpy(), v.numpy(), p.numpy(), self.state.t + float(np.sum(dts)))
        return self.state


class RealTimeIMUIntegrator:  # pragma: no cover - hardware
    """REST-polling real-time integrator (imu.py:94-589); requires
    ``requests``. The poll loop gathers (gyro, accel, ts) rows and feeds
    :class:`IMUPreintegrator` in batches."""

    def __init__(self, api: str = "http://localhost:8000/imu", poll_s: float = 0.05,
                 calib_samples: int = 200):
        self.api = api
        self.poll_s = poll_s
        self.calib_samples = calib_samples
        self.pre = IMUPreintegrator()
        self._running = False
        self._thread = None
        self._last_ts: Optional[float] = None

    def start(self):
        import threading

        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)

    def get_state(self) -> IMUState:
        return self.pre.state

    def _fetch(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        import requests

        try:
            rows = requests.get(self.api, timeout=2.0).json().get("imu", [])
        except Exception:
            return None
        rows = [r for r in rows if self._last_ts is None or r[-1] > self._last_ts]
        if not rows:
            return None
        arr = np.asarray(rows, np.float64)
        gyro, accel, ts = arr[:, 0:3], arr[:, 3:6], arr[:, 6]
        prev = self._last_ts if self._last_ts is not None else ts[0]
        dts = np.diff(np.concatenate([[prev], ts]))
        self._last_ts = float(ts[-1])
        return gyro, accel, dts

    def _loop(self):
        calib_g, calib_a = [], []
        while self._running:
            batch = self._fetch()
            if batch is None:
                time.sleep(self.poll_s)
                continue
            gyro, accel, dts = batch
            if len(calib_g) * 1.0 < self.calib_samples:
                calib_g.append(gyro)
                calib_a.append(accel)
                if sum(len(g) for g in calib_g) >= self.calib_samples:
                    self.pre.calibrate_static(np.vstack(calib_g), np.vstack(calib_a))
                time.sleep(self.poll_s)
                continue
            self.pre.update(gyro, accel, dts)
            time.sleep(self.poll_s)
