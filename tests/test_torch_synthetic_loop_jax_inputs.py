"""The loop row of the synthetic harness on the JAX harness's exact inputs:
the port's ``tools/eval_synthetic.run_loop`` beside the JAX package's
``scripts/eval_synthetic.run_loop``, at 14 and 16 frames (the JAX test's
size and its row of record), with and without retrieval, in one subprocess
(both oracles patch their model modules).

The inputs the port's harness otherwise draws itself come from JAX:
- the pointmap noise, through ``tools/eval_synthetic._noisy``: the JAX
  harness runs with x64 on, so its plane-world pointmaps are f64 and its
  normals are f64 draws of ``jax.random`` keyed by the f32 pose; they are
  added in f64 and rounded to the port's f32;
- the retrieval head, ``RetrievalHead.init(PRNGKey(1), ...)`` moved over with
  ``models/convert.retrieval_state_dict_from_jax`` (the 64-word codebook is
  the same numpy draw in both).

Bars: the loop edges (non-consecutive ``backend._pairs``) equal JAX's; JAX's
pairs a prefix of the port's (JAX loses the last frame of the 16-frame run
without retrieval, the port tracks it); every frame tracked by the port; the
ATE within a factor 1.5 of JAX's either way (measured 0.85-1.28), and JAX's
own bars on the port's rows (``tests/test_synthetic_e2e.py:82-106``): long
loop edges with retrieval, the ATE with retrieval at most 1.05 x without.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS = [(14, True), (14, False), (16, True), (16, False)]


def _jax_noisy64(X, T_WC, salt, noise):
    """The JAX plane oracle's noise under x64 (scripts/eval_synthetic.py
    ``noisy``): f64 normals keyed by the f32 pose, added in f64."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    if noise <= 0:
        return X
    T = jnp.asarray(T_WC.detach().cpu().numpy(), jnp.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.abs(jnp.sum(T * 1e4)).astype(jnp.int32) + salt)
    n = np.asarray(jax.random.normal(key, tuple(X.shape), jnp.float64))
    return (X.double() + noise * torch.from_numpy(n).to(X.device)).to(X.dtype)


def _jax_db(nfeat, device):
    """The JAX harness's random retrieval head and codebook, in the port."""
    import jax
    import numpy as np

    from frodo_slam_tpu.models import mast3r as jmast3r
    from frodo_slam_tpu.retrieval.model import RetrievalHead as JHead
    from frodo_slam_tpu_torch.models import convert
    from frodo_slam_tpu_torch.retrieval.asmk import Codebook
    from frodo_slam_tpu_torch.retrieval.database import RetrievalDatabase
    from frodo_slam_tpu_torch.retrieval.model import RetrievalHead

    dim = jmast3r.tiny_config().enc_embed_dim
    jhead = JHead.init(jax.random.PRNGKey(1), backbone_dim=dim, hdims=[dim], nfeat=nfeat)
    head = RetrievalHead(dim, [dim], nfeat)
    head.load_state_dict(convert.retrieval_state_dict_from_jax(jax.tree.map(np.asarray, jhead.params)))
    return RetrievalDatabase(head.to(device).eval(), Codebook.random(np.random.default_rng(0), 64, dim, device=device))


def _run() -> dict:
    import torch

    spec = importlib.util.spec_from_file_location("jax_eval_synthetic", ROOT / "scripts" / "eval_synthetic.py")
    jsynth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsynth)  # JAX on the CPU, x64 on

    import frodo_slam_tpu.slam.system as jsys
    import frodo_slam_tpu_torch.slam.system as tsys
    from frodo_slam_tpu_torch.tools import eval_synthetic as tsynth

    torch.set_num_threads(1)
    tsynth._noisy = _jax_noisy64
    tsynth._random_db = _jax_db
    made = {}
    for name, mod in (("jax", jsys), ("port", tsys)):
        class Spy(mod.SLAM):
            _name = name

            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made[self._name] = self

        mod.SLAM = Spy
    out = {}
    for n, retrieval in RUNS:
        row = {"jax": jsynth.run_loop(n, 0.004, with_retrieval=retrieval),
               "port": tsynth.run_loop(n, 0.004, with_retrieval=retrieval, device="cpu")}
        for name in ("jax", "port"):
            row[name]["pairs"] = [list(p) for p in made[name].backend._pairs]
        out[f"{n}_{retrieval}"] = row
    return out


@pytest.fixture(scope="module")
def rows():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__], capture_output=True, text=True, timeout=1200, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(out))
    return out


@pytest.mark.parametrize("n_frames", [14, 16])
def test_loop_row_on_jax_inputs(rows, n_frames):
    for retrieval in (True, False):
        j, t = rows[f"{n_frames}_{retrieval}"]["jax"], rows[f"{n_frames}_{retrieval}"]["port"]
        loops = lambda pairs: [p for p in pairs if abs(p[1] - p[0]) > 1]  # noqa: E731
        assert loops(t["pairs"]) == loops(j["pairs"]), (retrieval, t["pairs"], j["pairs"])
        assert t["pairs"][:len(j["pairs"])] == j["pairs"]
        assert t["frames_tracked_ok"] == t["n_kf"] == n_frames >= j["frames_tracked_ok"]
        assert j["ate_rmse"] / 1.5 <= t["ate_rmse"] <= 1.5 * j["ate_rmse"], (retrieval, t, j)
    on, off = rows[f"{n_frames}_True"]["port"], rows[f"{n_frames}_False"]["port"]
    assert on["n_long_loop_edges"] >= 1 and off["n_loop_edges"] == 0
    assert on["ate_rmse"] <= 1.05 * off["ate_rmse"], (on, off)


if __name__ == "__main__":
    print(json.dumps(_run()), flush=True)
