"""The synthetic harness's VIO row through the PyTorch port, on the CPU:
``python -m frodo_slam_tpu_torch.tools.eval_synthetic --vio`` (the JAX
package's ``scripts/eval_synthetic.py --vio``): wheel-odometry factors and
the scale-only PGO must recover METRIC scale on a world rendered at the
monocular gauge 0.5.

The port's oracle draws its pointmap noise from its own generator; this
test feeds it the JAX oracle's exact draws (``jax.random`` keyed by the
pose, as ``scripts/eval_synthetic.py`` renders them), so the row is held to
the JAX test's bars (``tests/test_synthetic_e2e.py:126-134``) on the same
inputs: 16 frames at 2 mm, all tracked with and without odometry;
``ate_sim3`` < 0.03; the metric trajectory's SE(3)-aligned ATE < 0.06 and
< 0.5 x the run without odometry. The oracle patches the model entry
points module-wide, so the row runs in a subprocess (this file as a
script)."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_noisy(X, T_WC, salt, noise):
    """The JAX harness's noise (scripts/eval_synthetic.py ``render``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    if noise <= 0:
        return X
    T = jnp.asarray(T_WC.detach().cpu().numpy(), jnp.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.abs(jnp.sum(T * 1e4)).astype(jnp.int32) + salt)
    n = jax.random.normal(key, tuple(X.shape), jnp.float32)
    return X + noise * torch.from_numpy(np.array(n)).to(X.device, X.dtype)


def _run() -> dict:
    import jax
    import torch

    from frodo_slam_tpu_torch.tools import eval_synthetic as tsynth

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    tsynth._noisy = _jax_noisy
    return {"vio": tsynth.run_vio(16, 0.002, use_odometry=True, device="cpu"),
            "no_odom": tsynth.run_vio(16, 0.002, use_odometry=False, device="cpu")}


def test_vio_metric_scale_on_jax_inputs():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__], capture_output=True, text=True, timeout=900, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(out))
    on, off = out["vio"], out["no_odom"]
    assert on["frames_tracked_ok"] == 16 and off["frames_tracked_ok"] == 16, out
    assert on["n_kf"] == off["n_kf"] == 16
    assert on["ate_sim3"] < 0.03, out
    assert on["ate_se3_scaled"] < 0.06, out
    assert on["ate_se3_scaled"] < 0.5 * off["ate_se3_scaled"], out


if __name__ == "__main__":
    print(json.dumps(_run()), flush=True)
