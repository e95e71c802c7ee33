"""PyTorch port vs the JAX package: the end-to-end bench, ``bench.py`` and
``frodo_slam_tpu_torch/tools/bench.py``, on the same inputs.

``bench.py`` is loaded by its path (it imports only the JAX package) and
runs with x64 off, as it runs on its own. Bars: the frames bitwise; the
window's integers and masks exact, its floats atol 1e-5 x max(1, |x|);
one backend step's solved poses atol 1e-5 (both solve in f32); the model
FLOP count at most 2% under XLA's count of the unrolled programs and never
over it (XLA also counts the elementwise work, which the port's count
leaves out); the whole tool's keyframe, fnn and gate-miss counts equal to a
run of ``bench.py`` at the same settings.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.config import make_config as j_make_config
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.ops import lie as jlie
from frodo_slam_tpu.ops import matching as jmatching
from frodo_slam_tpu.slam import backend as jbe
from frodo_slam_tpu.slam import frame as jframe
from frodo_slam_tpu.slam import global_opt as jgo
from frodo_slam_tpu.slam import inference as jinf
from frodo_slam_tpu.slam import tracker as jtr
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.slam.global_opt import BAConfig
from frodo_slam_tpu_torch.tools import bench as tbench

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, WIN = 32, 64, 8  # bench.py's tiny sizes


@contextlib.contextmanager
def jax_x64_off():
    """bench.py's numerics (x64 off); the suite runs with x64 on
    (tests/conftest.py), switched back on whatever happens."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def jb():
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    """bench.py's weights at tiny_config: ``init_params(PRNGKey(0))`` with x64
    off, the second decoder and head shared with the first, the transformer
    cast; and the port's model converted from them."""
    jcfg = jmast3r.tiny_config()
    with jax_x64_off():
        params = jmast3r.init_params(jax.random.PRNGKey(0), jcfg)
        params["head2"] = params["head1"]
        params["dec_blocks2"] = params["dec_blocks"]
        params = jmast3r.cast_transformer_params(params, jcfg.dtype)
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return params, jcfg, model


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_world(hw, n):
    """bench.py's window draws (``_steady_state_window``, :112-117)."""
    kp, kx = jax.random.split(jax.random.PRNGKey(7))
    pts = jax.random.uniform(kp, (hw, 3), minval=-2.0, maxval=2.0) + jnp.array([0, 0, 6.0])
    xis = jax.random.normal(kx, (n, 7)) * jnp.array([0.3, 0.3, 0.3, 0.15, 0.15, 0.15, 0.05])
    return _t(pts), _t(xis)


# ---------------------------------------------------------------------------
# frames and window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,hw,n", [(0, (32, 64), 10), (12345, (32, 64), 2), (0, (288, 512), 9),
                                       (12345, (288, 512), 2)])
def test_synthetic_frames_bitwise(jb, seed, hw, n):
    want = jb._synthetic_frames(np.random.default_rng(seed), *hw, n)
    got = tbench.synthetic_frames(np.random.default_rng(seed), *hw, n)
    assert len(got) == n
    for a, b in zip(want, got):
        assert b.dtype == torch.float32 and b.shape == (1, *hw, 3)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# bench.py:262-274 worked by hand: a third and two thirds in, plus one,
# moved off multiples of KF_EVERY = 8; none below 16 frames
@pytest.mark.parametrize("n,want", [(8, ()), (15, ()), (16, (6, 11)), (18, (7, 13)), (21, (9, 15)),
                                    (32, (11, 22)), (64, (22, 43)), (128, (43, 86))])
def test_decorrelated_frame_indices(n, want):
    assert tbench.decorrelated_indices(n) == want


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("hw,n", [(H * W, WIN), (288 * 512, 64)])
def test_window_matches_bench(jb, hw, n):
    """The steady-state window (the bench's 64 poses at 288x512 and the
    tiny run's 8) from JAX's own draws, against ``_steady_state_window``."""
    with jax_x64_off():
        T_true, X, C, edges = jb._steady_state_window(hw, n)
        pts, xis = _jax_world(hw, n)
    win = tbench.steady_state_window(pts, xis)
    assert win.poses == n and win.edges.ii.shape == (2 * n,)
    _close(win.T_true.numpy(), T_true)
    _close(win.X.numpy(), X)
    np.testing.assert_array_equal(win.C.numpy(), np.asarray(C))
    for name in ("ii", "jj", "idx", "valid", "Q", "active"):
        np.testing.assert_array_equal(getattr(win.edges, name).numpy(), np.asarray(getattr(edges, name)),
                                      err_msg=name)
    _close(win.edges.XiT.numpy(), edges.XiT)
    _close(win.edges.w0.numpy(), edges.w0)
    assert win.edges.XiT.is_contiguous()


def test_perturb_noise_leaves_pose_0():
    a, b = tbench.perturb_noise(5, WIN), tbench.perturb_noise(5, WIN)
    assert torch.equal(a, b) and not torch.equal(a, tbench.perturb_noise(6, WIN))
    assert torch.all(a[0] == 0) and torch.all(a[1:].abs().sum(-1) > 0)


# ---------------------------------------------------------------------------
# one backend step
# ---------------------------------------------------------------------------

def _tracked(jb, params, jcfg, match_cfg):
    """bench.py's warm-up state (:383-398): the map from frame 0, frame 1
    tracked against it. Returns (kf, fused, TrackResult)."""
    cfg = j_make_config()
    tcfg = jtr.TrackingCfg(min_match_frac=0.0, max_iters=int(cfg.tracking.max_iters), Q_conf=0.0,
                           match_frac_thresh=float(cfg.tracking.match_frac_thresh))
    frames = jb._synthetic_frames(np.random.default_rng(0), H, W, 2)
    feat, pos = jmast3r.encode_image(params, jcfg, frames[0])
    f0 = jframe.make_empty_frame(0, frames[0], feat, pos)
    X0, C0 = jinf.decode_mono(params, jcfg, feat, pos, (H, W))
    Xn, Cn, Nn, Un = jframe.update_pointmap(f0.X_canon, f0.C, f0.N, f0.N_updates, X0, C0)
    kf = dataclasses.replace(f0, X_canon=Xn, C=Cn, N=Nn, N_updates=Un)
    f1, p1 = jmast3r.encode_image(params, jcfg, frames[1])
    return jtr.track_step(params, jcfg, tcfg, tuple(sorted(match_cfg.items())), (H, W), kf,
                          jframe.make_empty_frame(0, frames[1], f1, p1), None)


def _jax_backend_step(jb, params, jcfg, mc, kf, fused, res, noise):
    """bench.py's ``backend_step`` (:336-380) on the half-reuse path, composed
    from the same JAX functions. Returns (edges, T_new, T_init)."""
    hw = H * W
    T_true, X_win, C_win, edges0 = jb._steady_state_window(hw, WIN)
    cfg = j_make_config()
    idx_j2i, vm_i, Qjj, Qij = res.pair_half
    res11, res21 = jinf.decode_asymmetric(params, jcfg, kf.feat, kf.pos, fused.feat, fused.pos, (H, W))
    idx_seed, seeded = jbe._invert_match(idx_j2i.astype(jnp.int32), vm_i)
    idx_i2j, vm_j = jmatching.match_split(res11["pts3d"], res21["pts3d"], res11["desc"], res21["desc"],
                                          idx_seed, **jmatching.seed_match_cfg(mc))
    vm_j = vm_j & seeded[..., None]
    z, one = jnp.float32(0.0), jnp.ones((1,), jnp.int32)
    Qj, Qi, valid_j, valid_i, _, a, b, c, d = jbe._ingest_pairs(
        z, z, z, X_win[WIN - 2: WIN - 1], C_win[WIN - 2: WIN - 1], one, X_win[WIN - 1:], C_win[WIN - 1:], one,
        idx_i2j.astype(jnp.int32), idx_j2i.astype(jnp.int32), vm_j, vm_i, res11["desc_conf"].reshape(1, hw, 1),
        Qjj, res21["desc_conf"].reshape(1, hw, 1), Qij)
    edges = jbe._write_pair_rows(jax.tree.map(jnp.copy, edges0), jnp.int32(2 * (WIN - 1)), jnp.int32(WIN - 2),
                                 jnp.int32(WIN - 1), idx_i2j[0], idx_j2i[0], valid_j[0, :, 0], valid_i[0, :, 0],
                                 Qj[0, :, 0], Qi[0, :, 0], cache=(a[0], b[0], c[0], d[0]))
    ba = jgo.BAConfig(max_iters=int(cfg.local_opt.max_iters), pin=1, delta_norm=float(cfg.local_opt.delta_norm))
    T_init = jax.vmap(jlie.sim3_retr)(T_true, noise)
    T_new = jgo.solve_gn_rays(ba, 1, T_init, X_win, C_win, edges, jgo.empty_odom_edges(1),
                              jnp.full((WIN,), -1.0, jnp.float32))
    return edges, np.asarray(T_new), np.asarray(T_init)


@pytest.mark.parametrize("refine", ["gather", "auto"])
def test_backend_step_matches_bench(jb, tiny, refine):
    """One half-reuse backend step (the decode of the missing direction, the
    inverse-seeded match, ingest, the in-place row write, the f32 window
    solve) on bench.py's tiny weights, tracker state and perturbation noise
    (``PRNGKey(1)``). Poses atol 1e-5 (measured 1.8e-6 for a 0.15 step).
    The live rows' masks (whose means are the gate fractions) are equal. Their matches agree
    on >= 99% of the pixels with the f32 refine (measured 99.95%); with
    ``auto`` (the bench's default: bf16 probes in both packages, the JAX
    shift refine against the port's kernel twin) the refine picks among
    near-tied scores differently (ROADMAP §3), so only the masks are held.
    At random weights the live pair has no valid match: the solve moves on
    the consistent world alone, as in bench.py."""
    params, jcfg, model = tiny
    mc = dict(j_make_config().matching, refine_impl=refine)
    with jax_x64_off():
        kf, fused, res = _tracked(jb, params, jcfg, mc)
        noise = (jax.random.normal(jax.random.PRNGKey(1), (WIN, 7))
                 * jnp.array([0.05] * 3 + [0.02] * 3 + [0.01])).at[0].set(0.0).astype(jnp.float32)
        j_edges, T_j, T_init = _jax_backend_step(jb, params, jcfg, mc, kf, fused, res, noise)
        pts, xis = _jax_world(H * W, WIN)
    assert T_j.dtype == np.float32
    cfg = j_make_config()
    b = tbench.Backend(model, mc, (H, W), BAConfig(max_iters=int(cfg.local_opt.max_iters), pin=1,
                                                     delta_norm=float(cfg.local_opt.delta_norm), solve_f64=False),
                       tbench.steady_state_window(pts, xis))
    edges, T_t, stats = tbench.backend_step(
        b, tbench.clone_edges(b.win.edges), _t(kf.feat), _t(kf.pos), _t(fused.feat), _t(fused.pos), _t(noise),
        tuple(_t(x) for x in res.pair_half))
    assert stats["iters"] == 10
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-5)
    assert np.abs(T_j - T_init).max() > 0.1  # the solve moved the poses
    live = slice(2 * (WIN - 1), 2 * WIN)
    for name in ("ii", "jj", "valid", "active"):
        np.testing.assert_array_equal(getattr(edges, name).numpy(), np.asarray(getattr(j_edges, name)), name)
    _close(edges.w0.numpy(), j_edges.w0)
    if refine == "gather":
        same = edges.idx[live].numpy() == np.asarray(j_edges.idx[live])
        assert same.mean() >= 0.99, same.mean()
        _close(edges.XiT[live].numpy()[:, :, same.all(0)], np.asarray(j_edges.XiT[live])[:, :, same.all(0)])


# ---------------------------------------------------------------------------
# the model FLOP count
# ---------------------------------------------------------------------------

def _xla_flops(jcfg, hw, unroll):
    """XLA's cost analysis of bench.py's two model programs (encode, and
    ``_model_stage``: the pair decode with both heads), lowered only, with
    every ``lax.scan`` unrolled or as it is. Returns (encode, decode)."""
    jax.clear_caches()  # the traced programs are cached per function
    real = jax.lax.scan
    if unroll:
        jax.lax.scan = functools.partial(real, unroll=True)
    try:
        params = jax.eval_shape(lambda: jmast3r.cast_transformer_params(
            jmast3r.init_params(jax.random.PRNGKey(0), jcfg), jcfg.dtype))
        img = jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32)
        enc = jax.jit(lambda p, x: jmast3r.encode_image(p, jcfg, x))
        feat, pos = jax.eval_shape(enc, params, img)
        flops = [enc.lower(params, img).cost_analysis(),
                 jinf._model_stage.lower(params, jcfg, feat, pos, feat, pos, hw).cost_analysis()]
        return tuple(float((f[0] if isinstance(f, list) else f)["flops"]) for f in flops)
    finally:
        jax.lax.scan = real
        jax.clear_caches()


@pytest.mark.parametrize("name,hw", [("tiny", (32, 64)), ("vitl", (288, 512))])
def test_model_flops_count_every_layer(name, hw):
    """``model_flops`` against XLA's count of the unrolled programs: the
    total at most 2% under, never over (XLA adds the elementwise work); at
    ViT-L each program too (measured: encode 1.3% under, decode and heads
    0.9%, total 1.04% of 1.1165 TFLOP). bench.py counts a scanned stack's
    body once: its count (0.4585 TFLOP at ViT-L 288x512) is printed beside
    and is under half of every layer's."""
    with jax_x64_off():
        jcfg = jmast3r.tiny_config() if name == "tiny" else jmast3r.MASt3RConfig()
        enc_u, dec_u = _xla_flops(jcfg, hw, unroll=True)
        enc_s, dec_s = _xla_flops(jcfg, hw, unroll=False)
    got = tmast3r.model_flops(tmast3r.tiny_config() if name == "tiny" else tmast3r.MASt3RConfig(), hw)
    print(f"{name}: port {got['total'] / 1e12:.7f} TFLOP, XLA unrolled {(enc_u + dec_u) / 1e12:.7f}, "
          f"XLA scanned (bench.py) {(enc_s + dec_s) / 1e12:.7f}")
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    total = enc_u + dec_u
    assert 0.98 * total <= got["total"] <= total
    if name == "vitl":
        assert 0.98 * enc_u <= got["encode"] <= enc_u
        assert 0.98 * dec_u <= got["total"] - got["encode"] <= dec_u
        assert abs(total / 1e12 - 1.1165) < 5e-4
        assert enc_s + dec_s < 0.5 * got["total"]


# ---------------------------------------------------------------------------
# the whole tool
# ---------------------------------------------------------------------------

KNOBS = {"FRODO_BENCH_TINY": "1", "FRODO_BENCH_FRAMES": "18"}


def test_tool_counts_match_bench(tiny, tmp_path):
    """The tool on the CPU at tiny width, 18 frames (the cadence cap fires,
    both decorrelated frames are placed), threaded, with bench.py's
    converted weights, against a run of bench.py at the same settings: the
    same keyframe, fnn and gate-miss counts; the line carries bench.py's keys
    and the port's own."""
    env = dict(os.environ, **KNOBS, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(ROOT / "bench.py")], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    out = tbench.run(model=tiny[2], device="cpu", environ=KNOBS)
    got = out["line"]
    assert set(want) <= set(got), set(want) - set(got)
    for key in ("metric", "unit", "frames", "kf_frames", "fnn_frames", "gate_miss_frames", "threaded"):
        assert got[key] == want[key], (key, got, want)
    assert got["frames"] == 16 and got["fnn_frames"] == 2 and got["kf_frames"] >= 2
    assert got["value"] > 0 and got["synced_fps"] > 0 and got["p99_ms"] >= got["p50_ms"] > 0
    assert got["x64_eval"] is False and got["window_rows"] == 2 * WIN and got["device"] == "cpu"
    assert got["mfu_pct"] is None and got["peak_gb"] is None
    assert got["model_tflop_frame"] == round(tmast3r.model_flops(tmast3r.tiny_config(), (H, W))["total"]
                                             / 1e12, 4)
    det = out["detail"]
    assert sorted(map(int, det["decorrelated"])) == [7, 13]
    assert len(det["tasks_pass1"]) == len(det["tasks_pass2"]) == got["kf_frames"]
    assert len(det["frame_ms_pass1"]) == 16
    assert det["allow_tf32"] == {"cudnn": False, "matmul": False}  # the f32 contract, as SLAM holds it


def test_tool_inline_backend_runs_every_keyframe(tiny):
    """``FRODO_BENCH_THREADED=0``: the backend inline, one task a keyframe in
    each pass, each solve 10 GN iterations."""
    out = tbench.run(model=tiny[2], device="cpu", environ=dict(KNOBS, FRODO_BENCH_THREADED="0"))
    line, det = out["line"], out["detail"]
    assert line["threaded"] is False and line["kf_frames"] == len(det["kf_frame_idx"]) >= 2
    for tasks in (det["tasks_pass1"], det["tasks_pass2"]):
        assert [t["iters"] for t in tasks] == [10] * line["kf_frames"]


def test_tool_track_only_runs_no_backend_work(tiny):
    """``FRODO_BENCH_TRACK_ONLY=1``: the same keyframe decisions, no backend
    task in either pass."""
    out = tbench.run(model=tiny[2], device="cpu", environ=dict(KNOBS, FRODO_BENCH_TRACK_ONLY="1"))
    line, det = out["line"], out["detail"]
    assert line["kf_frames"] == len(det["kf_frame_idx"]) >= 2 and line["fnn_frames"] == 2
    assert det["tasks_pass1"] == det["tasks_pass2"] == []
    assert line["value"] > 0 and line["synced_fps"] > 0


def test_tool_without_a_card_exits_nonzero_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run()
    proc = subprocess.run([sys.executable, "-m", "frodo_slam_tpu_torch.tools.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stdout
