"""Every cell, configuration, mix and metric of BENCHMARK.json loads, and
the file keeps to the benchmark's contract."""

import json
import math
import re

import pytest
import torch

from slambench import run, weights, yardstick
ROOT = __import__('pathlib').Path(__file__).resolve().parents[2]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
VIT_L = dict(patch_size=16, enc_embed_dim=1024, enc_depth=24, enc_num_heads=16, dec_embed_dim=768,
             dec_depth=12, dec_num_heads=12, local_feat_dim=24, dpt_feature_dim=256)


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} == {"fps", "peak_gb", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "fps" and "fps" in e2e and "workloads" not in e2e["fps"]
        # every reader names its cells, so a cell that a later change adds gets none by accident
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(workload):
    c = run.load_cell(workload)
    assert c["cell"]["name"] == workload and c["arch"] == "mast3r"
    assert {"match_frac_thresh", "session_frames", "images", "warmup_frames", "trace_frames"} <= set(c["traffic"])
    assert set(c["limits"]) == {"pts_rel_ratio", "conf_excess_rel_p50", "pose_dist_max", "discrete_mismatch",
                                "head_rel_err"}
    for m in c["per_layer"]:
        assert callable(run.load_metric(m["name"]).read)


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_published_vit_l(conf):
    import yaml

    entry = {c["name"]: c for c in BENCH["configs"]}[conf]
    cfg = yaml.safe_load((ROOT / entry["file"]).read_text())
    assert "inherit" not in cfg
    for k, v in VIT_L.items():
        assert cfg["model"][k] == v
    assert abs(weights.n_params(cfg["model"]) - 688.6e6) < 0.1e6
    # the port's loader reads the whole file
    from frodo_slam_tpu_torch.config import make_config

    loaded = make_config(str(ROOT / entry["file"]))
    assert loaded["tpu"]["dtype"] == "bfloat16" and loaded["tpu"]["head_dtype"] == "float32"


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_weights_name_every_parameter_of_the_port(conf):
    import yaml

    from frodo_slam_tpu_torch.models import mast3r

    m = yaml.safe_load((ROOT / {c["name"]: c for c in BENCH["configs"]}[conf]["file"]).read_text())["model"]
    cfg = mast3r.MASt3RConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    with torch.device("meta"):
        sd = mast3r.MASt3R(cfg).state_dict()
    specs = {n: s for n, s, _, _ in weights.param_specs(m)}
    for name, t in sd.items():
        src = name.replace("dec_blocks2.", "dec_blocks.").replace("downstream_head2.", "downstream_head1.")
        assert tuple(t.shape) == specs[src], name
    assert len(sd) == len(specs) + sum(1 for n in specs if n.startswith(("dec_blocks.", "downstream_head1.")))


def test_weights_are_seeded_and_typed():
    from tiny import TINY

    m = dict(yaml_model(), **TINY)
    a = weights.make(m, 2 ** 31 + 11, "cpu")
    b = weights.make(m, 2 ** 31 + 11, "cpu")
    c = weights.make(m, 2 ** 31 + 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc_blocks.0.attn.qkv.weight"], c["enc_blocks.0.attn.qkv.weight"])
    assert a["enc_blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert a["enc_norm.weight"].dtype == torch.float32
    assert a["downstream_head1.dpt.head.0.weight"].dtype == torch.float32
    assert torch.equal(a["dec_blocks2.3.mlp.fc1.weight"], a["dec_blocks.3.mlp.fc1.weight"])
    w = a["enc_blocks.0.mlp.fc1.weight"].float()
    assert abs(w.std().item() - math.sqrt(2.0 / sum(w.shape))) < 0.1 * math.sqrt(2.0 / sum(w.shape))


def yaml_model():
    import yaml

    return yaml.safe_load((ROOT / BENCH["configs"][0]["file"]).read_text())["model"]


@pytest.mark.parametrize("hw,tflop", [((288, 512), 1.1049), ((384, 512), 1.5102)])
def test_frozen_flop_count_matches_the_port(hw, tflop):
    from frodo_slam_tpu_torch.models import mast3r

    ours = yardstick.model_flops(yaml_model(), hw)
    assert ours == mast3r.model_flops(mast3r.MASt3RConfig(), hw)
    assert round(ours["total"] / 1e12, 4) == tflop


def test_frozen_frames_are_the_bench_tools_draws():
    import numpy as np

    from frodo_slam_tpu_torch.tools.bench import synthetic_frames

    img = yardstick.wave_field(np.random.default_rng(5), 32, 64)
    ref = synthetic_frames(np.random.default_rng(5), 32, 64, 1)[0][0].numpy()
    assert img.dtype == np.uint8 and img.shape == (32, 64, 3)
    assert np.abs(img.astype(np.float32) / 127.5 - 1.0 - ref).max() <= 0.5 / 127.5 + 1e-6
