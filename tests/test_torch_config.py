"""PyTorch port vs JAX package: ``config.apply_x64_knob``, the resolution of
``tpu.x64_eval`` for each entry point, over the matrix of
``tests/test_config.py:81-108``: the entry point's default where the config
has no value (base.yaml), ``configs/realtime.yaml`` and
``configs/bench_cli.yaml`` off whatever the default, the eval configs on.
The port writes the value into the config, where ``SLAM`` reads it into
``BAConfig.solve_f64``, and sets no global numerics state; its config
module is read without importing JAX.
"""

import json
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from frodo_slam_tpu.config import apply_x64_knob as j_apply_x64_knob
from frodo_slam_tpu.config import make_config as j_make_config
from frodo_slam_tpu_torch.config import apply_x64_knob, make_config

ROOT = pathlib.Path(__file__).resolve().parents[1]

MATRIX = [  # (config, entry point default, resolved)
    ("base.yaml", True, True),
    ("base.yaml", False, False),
    ("realtime.yaml", True, False),
    ("realtime.yaml", False, False),
    ("bench_cli.yaml", True, False),
    ("eval_calib.yaml", False, True),
    ("eval_no_calib.yaml", False, True),
]


@pytest.mark.parametrize("name,default,want", MATRIX)
def test_apply_x64_knob_matches_jax(name, default, want):
    path = str(ROOT / "configs" / name)
    cfg = make_config(path)
    dtype = torch.get_default_dtype()
    assert apply_x64_knob(cfg, entry_default=default) is want
    assert cfg["tpu"]["x64_eval"] is want  # written back for SLAM
    assert torch.get_default_dtype() == dtype
    assert apply_x64_knob(cfg, entry_default=not default) is want  # now explicit
    prev = jax.config.jax_enable_x64
    try:
        assert j_apply_x64_knob(j_make_config(path), entry_default=default) is want
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_apply_x64_knob_reads_no_jax():
    """The port's config module resolves the knob in a process that never
    imports JAX."""
    code = ("import json, sys\n"
            "from frodo_slam_tpu_torch.config import apply_x64_knob, make_config\n"
            "cfg = make_config('configs/realtime.yaml')\n"
            "print(json.dumps([apply_x64_knob(cfg, True), 'jax' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, False]


@pytest.mark.parametrize("x64_eval", [None, True, False])
def test_slam_reads_solve_numerics(x64_eval):
    """``SLAM`` carries the resolved value into the backend's BAConfig; a
    config without it (a SLAM built directly) solves in f64."""
    from frodo_slam_tpu_torch.models import mast3r
    from frodo_slam_tpu_torch.slam.system import SLAM

    cfg = make_config(tpu={"max_keyframes": 4, "max_edges": 4, "max_odom_edges": 4})
    if x64_eval is not None:
        cfg["tpu"]["x64_eval"] = x64_eval
    model = mast3r.init_model(mast3r.tiny_config(), seed=0, device="cpu")
    slam = SLAM(cfg, model, (32, 64), device="cpu")
    want = x64_eval is not False
    assert slam.ba_cfg.solve_f64 is want and slam.backend.cfg.solve_f64 is want
