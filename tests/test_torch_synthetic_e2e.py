"""The synthetic-oracle harness through the PyTorch port, on the CPU:
``python -m frodo_slam_tpu_torch.tools.eval_synthetic --device cpu``.

Each row runs in a subprocess, because the oracle patches the model entry
points module-wide. The bars are the JAX package's own
(``tests/test_synthetic_e2e.py``): straight, 10 frames at 3 mm: 10 tracked,
10 keyframes, ATE < 0.05; calibrated, 8 frames at noise 0: 8 and 8, ATE <
0.25. The sparse-keyframing row (``--per-frame``, the warm-started matcher
path) is held to the straight row's ATE bar with fewer keyframes than
frames. The loop and episode rows are in ``test_torch_synthetic_loop.py``.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_harness(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "frodo_slam_tpu_torch.tools.eval_synthetic", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(out))
    assert out["device"] == "cpu"
    return out


@pytest.mark.parametrize("per_frame", [False, True], ids=["straight", "per_frame"])
def test_synthetic_sequence_ate(tmp_path, per_frame):
    out = run_harness("--frames", "10", "--noise", "0.003", "--out", str(tmp_path),
                      *(["--per-frame"] if per_frame else []))
    assert out["frames_tracked_ok"] == 10
    if per_frame:
        assert 1 <= out["n_kf"] < 10  # warm frames were tracked against a keyframe
    else:
        assert out["n_kf"] == 10
    assert out["ate_rmse"] < 0.05, out


def test_calibrated_pipeline_on_plane_world(tmp_path):
    out = run_harness("--calib", "--frames", "8", "--noise", "0", "--out", str(tmp_path))
    assert out["frames_tracked_ok"] == 8 and out["n_kf"] == 8
    assert out["ate_rmse"] < 0.25, out
