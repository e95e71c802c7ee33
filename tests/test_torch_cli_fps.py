"""``tools/cli_fps.py``, the port's counterpart of ``scripts/cli_fps.py``, on
the CPU: the JAX script's frame (the same numpy draws, PNG bytes read back
equal to the cv2-written ones), a run of the committed runner with
``configs/bench_cli.yaml`` at the tiny width whose ``FPS:`` prints and
resolved numerics the tool parses into its JSON line, and a failing run
that makes the tool exit non-zero (the JAX script prints 0.0 and exits 0).

The runner resizes every frame to a 512-pixel long edge; here a shim runs
the same module with the datasets' long edge at 64 (as the runner tests
do), so 64 frames take seconds on the CPU.
"""

import importlib.util
import json
import pathlib
import sys
import tempfile

import numpy as np
import PIL.Image
import pytest

from frodo_slam_tpu_torch.tools import cli_fps

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHIM = """
import runpy, sys
from frodo_slam_tpu_torch.data import datasets
real = datasets.load_dataset
def small(path, **kw):
    ds = real(path, **kw)
    ds.img_size = 64
    return ds
datasets.load_dataset = small
sys.argv = ["frodo_slam_tpu_torch.main"] + sys.argv[1:]
runpy.run_module("frodo_slam_tpu_torch.main", run_name="__main__")
"""


def test_frames_match_the_jax_script(tmp_path):
    cv2 = pytest.importorskip("cv2")
    spec = importlib.util.spec_from_file_location("jax_cli_fps", ROOT / "scripts" / "cli_fps.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcli.make_frames(tmp_path / "jax", 2)
    cli_fps.make_frames(tmp_path / "port", 2)
    for i in range(2):
        want = cv2.imread(str(tmp_path / "jax" / f"{i:05d}.png"))[:, :, ::-1]
        got = np.asarray(PIL.Image.open(tmp_path / "port" / f"{i:05d}.png"))
        assert got.shape == (288, 512, 3)
        np.testing.assert_array_equal(got, want)


def _run(monkeypatch, capsys, tmp_path, *argv):
    real = cli_fps.runner_cmd
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tool's folder lands here
    monkeypatch.setattr(cli_fps, "runner_cmd", lambda seq, cfg, n: [sys.executable, "-c", SHIM,
                                                                    *real(seq, cfg, n)[3:]])
    monkeypatch.setenv("FRODO_ENTRY_TINY", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = cli_fps.main(["--device", "cpu", *argv])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_fps_runs_the_runner_and_parses_its_line(monkeypatch, capsys, tmp_path):
    rc, line = _run(monkeypatch, capsys, tmp_path, "--frames", "64")
    assert rc == 0 and line["rc"] == 0
    keys = {"metric", "value", "unit", "windows", "frames", "config", "rc"}  # scripts/cli_fps.py's
    assert keys <= set(line) and line["frames"] == 64 and line["unit"] == "frames/s"
    assert len(line["windows"]) == 2 and line["value"] == line["windows"][1] > 0  # 30-frame windows
    assert line["x64_eval"] is False and line["device"] == "cpu" and line["card"] == "cpu"
    assert line["config"].endswith("configs/bench_cli.yaml")
    assert not list(tmp_path.glob("cli_fps_*"))  # the folder is removed


def test_cli_fps_exits_nonzero_on_a_failed_run(monkeypatch, capsys, tmp_path):
    rc, line = _run(monkeypatch, capsys, tmp_path, "--frames", "4", "--config", str(tmp_path / "missing.yaml"))
    assert rc == 1 and line["rc"] != 0 and line["value"] is None and line["windows"] == []
    assert line["x64_eval"] is None  # the runner failed before it resolved the numerics
    # a run that ends without a single FPS window fails too
    rc, line = _run(monkeypatch, capsys, tmp_path, "--frames", "4")
    assert not list(tmp_path.glob("cli_fps_*"))
    assert rc == 1 and line["rc"] == 0 and line["windows"] == []

