"""Nothing the benchmark runs imports JAX or the JAX package; the yardstick
and the reference import nothing of the port."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "frodo_slam_tpu"}
STANDALONE = ("reference.py", "yardstick.py", "weights.py")


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            out |= {a.value for a in node.args[:1] if isinstance(a, ast.Constant)}
    return {m.split(".")[0] for m in out if m}


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")))
def test_no_jax(path):
    assert not imported(HERE / path) & FORBIDDEN


@pytest.mark.parametrize("name", STANDALONE)
def test_yardstick_and_reference_stand_alone(name):
    assert "frodo_slam_tpu_torch" not in imported(HERE / name)
    assert imported(HERE / name) <= {"__future__", "itertools", "math", "typing", "numpy", "torch", "PIL"}


def test_whole_names_compared():
    # the port's name begins with the JAX package's: whole top-level names
    assert "frodo_slam_tpu_torch".split(".")[0] not in FORBIDDEN
