"""Nothing the benchmark runs imports JAX or the JAX package; the yardstick
and the reference import nothing of the port; outside its adapter, the
harness takes nothing from MASt3R by name."""

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


# the frozen MASt3R functions, and the files that may call them: where they
# are defined, the architecture's adapter, the tests
FROZEN_CALLS = {("weights", "make"), ("reference", "Ref"), (None, "Ref"), (None, "network_input"),
                (None, "reference_views"), (None, "head_rel_err"), (None, "model_flops"),
                (None, "forward_attention_bound")}
MAY_NAME_MAST3R = {"archs/mast3r.py", "weights.py", "reference.py", "yardstick.py"}


def mast3r_by_name(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names if a.name.startswith("frodo_slam_tpu_torch.models.mast3r")]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = {f"{node.module}.{a.name}" for a in node.names} | {node.module}
            out += [n for n in names if n.startswith("frodo_slam_tpu_torch.models.mast3r")]
            out += [a.name for a in node.names if (None, a.name) in FROZEN_CALLS]
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and (None, f.id) in FROZEN_CALLS:
                out.append(f.id)
            elif isinstance(f, ast.Attribute) and ((getattr(f.value, "id", None), f.attr) in FROZEN_CALLS
                                                   or (None, f.attr) in FROZEN_CALLS):
                out.append(f.attr)
    return out


HARNESS = sorted(p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", [p for p in HARNESS if p not in MAY_NAME_MAST3R])
def test_no_mast3r_by_name_outside_its_adapter(path):
    assert not mast3r_by_name(HERE / path)


def test_the_by_name_check_sees_the_adapter():
    assert {"weights.make" if n == "make" else n for n in mast3r_by_name(HERE / "archs/mast3r.py")} >= {
        "frodo_slam_tpu_torch.models.mast3r", "Ref", "forward_attention_bound"}
