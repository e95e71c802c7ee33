"""The MASt3R architecture behind the seam gives, value for value, what the
harness gave before the seam: ``data/slambench_mast3r_frozen.json`` was
recorded from the frozen functions and readers as they were called directly
(parameter list, seeded weights, FLOP and attention-bound counts, network
inputs, the tiny reference in three precisions, the two work readers on a
hand-made summary). Every comparison is ``==``. Single-threaded on the CPU,
where the reference's products do not depend on the thread count."""

import hashlib
import json

import numpy as np
import pytest
import torch
import yaml

from slambench import run, yardstick
from tiny import tiny_cell

FROZEN = json.loads((run.ROOT / "slambench/tests/data/slambench_mast3r_frozen.json").read_text())
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
SEED = FROZEN["seed"]


@pytest.fixture(scope="module")
def arch():
    return run.load_arch("mast3r")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def model(conf):
    return yaml.safe_load((run.ROOT / CONFIGS[conf]["file"]).read_text())["model"]


def digest(t):
    t = torch.as_tensor(t).detach().contiguous().cpu()
    return {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
            "sha256": hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest(),
            "sum": float(t.double().sum())}


@pytest.mark.parametrize("conf", sorted(FROZEN["configs"]))
def test_param_specs_frozen(arch, conf):
    specs = [[n, list(s), list(k), g] for n, s, k, g in arch.param_specs(model(conf))]
    assert specs == FROZEN["configs"][conf]["param_specs"]


@pytest.mark.parametrize("conf", sorted(FROZEN["configs"]))
def test_work_counts_frozen(arch, conf):
    m, want = model(conf), FROZEN["configs"][conf]
    for key, fl in want["model_flops"].items():
        hw = tuple(int(x) for x in key.split("x"))
        assert arch.flops(m, hw) == fl
    for key, b in want["forward_attention_bound"].items():
        hw, batch, dtype = key.split(".")
        got = arch.forward_bounds(m, tuple(int(x) for x in hw.split("x")), int(batch[1:]), dtype)
        assert got == {"model.encode": b["encode"], "model.decode": b["decode"]}
        assert list(got) == list(arch.MODEL_SPANS)


def test_seeded_weights_frozen(arch):
    tm = tiny_cell("tum384.kf-every")["config"]["model"]
    assert tm == FROZEN["tiny_widths"]
    sd = arch.make_weights(tm, SEED, "cpu", dtype=torch.bfloat16, head_dtype=torch.float32)
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    assert {"n": len(sd), "sha256": h.hexdigest()} == FROZEN["tiny_weights"]


@pytest.mark.parametrize("hw", sorted(FROZEN["network_input"]))
def test_network_input_frozen(arch, hw):
    H, W = (int(x) for x in hw.split("x"))
    frame = yardstick.wave_field(np.random.default_rng([SEED, H]), H, W)
    assert digest(torch.from_numpy(arch.net_input(frame, 512))) == FROZEN["network_input"][hw]


@pytest.mark.parametrize("precision", ["f32", "bf16", "control"])
def test_tiny_reference_pair_frozen(arch, one_thread, precision):
    c = tiny_cell("tum384.kf-every")
    tm = c["config"]["model"]
    sd = arch.make_weights(tm, SEED, "cpu", dtype=torch.bfloat16, head_dtype=torch.float32)
    cam = tuple(FROZEN["tiny_pair"]["camera"])
    assert cam == (c["config"]["camera"]["height"], c["config"]["camera"]["width"])
    net = arch.net_input(yardstick.wave_field(np.random.default_rng([SEED, 1]), *cam),
                         int(c["config"]["camera"]["long_side"]))
    r1, r2 = arch.make_reference(sd, tm, precision=precision).pair(torch.as_tensor(net))
    got = {f"view{i}.{k}": digest(r[k]) for i, r in ((1, r1), (2, r2)) for k in ("pts3d", "conf")}
    assert got == FROZEN["tiny_pair"][precision]


@pytest.mark.parametrize("conf", sorted(FROZEN["readers"]))
def test_work_readers_frozen(conf):
    want = FROZEN["readers"][conf]
    s = dict(want["summary"], arch="mast3r", arch_root=str(run.ROOT),
             model_shape={"widths": model(conf), "img_hw": tuple(want["img_hw"]), "dtype": want["dtype"]})
    for name in ("attn_roofline_pct", "mfu_pct"):
        assert run.load_metric(name).read(s) == want[name], name
