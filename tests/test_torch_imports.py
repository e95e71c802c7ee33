"""The port stands alone: no module of ``frodo_slam_tpu_torch`` (nor
``chip_smoke.py``, ``kernel_ab.py``) imports ``jax`` or anything of ``frodo_slam_tpu``, no
module of the port imports ``cv2`` (but for the live robot poller's ORB yaw,
inside its functions: hardware the tests never run, and the one import of
the video decoder and the cameras, inside ``data.datasets.opencv``) or calls the library
attention ``scaled_dot_product_attention``, and its entry points run on the
card unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "frodo_slam_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))

# the dataset runner's modules, named so that a move or rename shows here
RUNNER_MODULES = ["frodo_slam_tpu_torch.main", "frodo_slam_tpu_torch.loader",
                  "frodo_slam_tpu_torch.data.datasets", "frodo_slam_tpu_torch.data.prefetch",
                  "frodo_slam_tpu_torch.utils.evaluate", "frodo_slam_tpu_torch.ops.attention_kernel"]
# the robot VIO path's modules
VIO_MODULES = ["frodo_slam_tpu_torch.run_vio", "frodo_slam_tpu_torch.slam.odometry",
               "frodo_slam_tpu_torch.slam.pgo", "frodo_slam_tpu_torch.slam.height_prior",
               "frodo_slam_tpu_torch.slam.imu", "frodo_slam_tpu_torch.slam.local_mapping",
               "frodo_slam_tpu_torch.utils.checkpoint", "frodo_slam_tpu_torch.utils.sigma_compute"]
# the viewer, the video and camera inputs and the codebook trainer
VIZ_MODULES = ["frodo_slam_tpu_torch.viz", "frodo_slam_tpu_torch.viz.web",
               "frodo_slam_tpu_torch.viz.visualization", "frodo_slam_tpu_torch.data.live",
               "frodo_slam_tpu_torch.tools.train_codebook"]
# multi-card placement and its dry run
PLACEMENT_MODULES = ["frodo_slam_tpu_torch.parallel", "frodo_slam_tpu_torch.parallel.mesh",
                     "frodo_slam_tpu_torch.tools.dryrun_multichip"]
# the end-to-end bench (the port's counterpart of bench.py)
BENCH_MODULES = ["frodo_slam_tpu_torch.tools.bench"]
# functions that may import OpenCV in their bodies: the live robot poller,
# and the one import of the video decoder and the cameras
CV2_FUNCTIONS = {"frodo_slam_tpu_torch/slam/odometry.py": {"yaw_from_rays", "_loop"},
                 "frodo_slam_tpu_torch/data/datasets.py": {"opencv"}}

torch.set_num_threads(1)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "frodo_slam_tpu")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_opencv_and_no_library_attention_in_the_port(path):
    """The card's machine has no OpenCV; every attention goes through the
    port's own kernel (chip_smoke.py times the library call only)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    allowed = CV2_FUNCTIONS.get(str(path.relative_to(ROOT)), set())
    exempt = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef) and f.name in allowed
              for n in ast.walk(f)}
    for node in ast.walk(tree):
        if id(node) in exempt:
            continue
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] != "cv2" for a in node.names), path.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] != "cv2", path.name
        elif isinstance(node, ast.Attribute):
            assert node.attr != "scaled_dot_product_attention", f"{path.name}:{node.lineno}"


def test_runner_modules_are_covered():
    assert set(RUNNER_MODULES) <= set(MODULES)


def test_vio_modules_are_covered():
    assert set(VIO_MODULES) <= set(MODULES)
    for rel, names in CV2_FUNCTIONS.items():
        tree = ast.parse((ROOT / rel).read_text())
        assert names <= {f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)}, rel


def test_viz_modules_are_covered():
    assert set(VIZ_MODULES) <= set(MODULES)


def test_placement_modules_are_covered():
    assert set(PLACEMENT_MODULES) <= set(MODULES)


def test_bench_modules_are_covered():
    assert set(BENCH_MODULES) <= set(MODULES)


def test_importing_the_viewer_loads_no_matplotlib_and_no_opencv():
    """The card's machine has no matplotlib: the viewer, the exports and the
    trainer import it (and OpenCV) only inside the functions that need it."""
    code = (
        "import importlib, sys\n"
        f"for m in {VIZ_MODULES + RUNNER_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(k for k in sys.modules if k.split('.')[0] in ('matplotlib', 'cv2', 'pyrealsense2'))\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'frodo_slam_tpu', 'cv2'))\n"
        "assert not leaked, leaked\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_slam_without_device_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None picks it")
    from frodo_slam_tpu_torch.config import make_config
    from frodo_slam_tpu_torch.models import mast3r
    from frodo_slam_tpu_torch.slam.system import SLAM
    from frodo_slam_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        mast3r.init_model(mast3r.tiny_config())
    model = mast3r.init_model(mast3r.tiny_config(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAM(make_config(), model, (32, 64))
    from frodo_slam_tpu_torch import loader

    with pytest.warns(UserWarning, match="RANDOM"), pytest.raises(RuntimeError, match="CUDA"):
        loader.load_mast3r("missing.pth", cfg=mast3r.tiny_config())
    assert resolve_device("cpu") == torch.device("cpu")
