"""PyTorch port vs JAX package: the dataset runner and the model loader.

``frodo_slam_tpu_torch.main.run`` and ``frodo_slam_tpu.main.run`` over the
same synthetic sequences, with the same converted tiny weights (shared heads
and decoders, so identical frames track) and the f32 refine on both sides,
at a 64-pixel long edge. Five runs: an image folder with base.yaml, the
same with a ``--calib`` yaml, the same with ``tpu.pipelined_frontend``, and
a TUM fr1 sequence with a config that inherits ``configs/eval_calib.yaml``
(calibrated tracker and backend, subsample 2); and the image folder with
``tpu.placement: shared``, the port's devices eight CPU aliases (a (4, 2)
backend grid, as JAX's on its eight virtual devices). Bars: keyframe count and timestamps exact, trajectories atol
1e-4 (the bar of tests/test_torch_system.py), keyframe PNGs equal, the PLY
vertex count equal and its points (decoded pointmaps moved by the
poses) within the decoder's bar of tests/test_model_parity.py, rtol 1e-3
and atol 1e-4. Two more runs over an 8-frame folder take the real-time
configurations, ``configs/realtime.yaml`` and ``configs/bench_cli.yaml``:
``tpu.x64_eval: false`` on both sides (JAX's x64-off program, the port's
f32 window solve with one refinement step), the pipelined frontend, the
threaded backend for bench_cli.yaml, the configs' head type; realtime.yaml's
bf16 heads get the bars stated at ``REALTIME_BARS``.

The prefetch loader: frames in order, uploads on the requested device, an
error in its thread raised at the frame where it happened.

The loader: the ``.npz`` route gives the converted state dict exactly; the
random route honours ``FRODO_ENTRY_TINY`` and ``FRODO_RANDOM_SHARE_DECODER``;
``apply_model_knobs`` reads every config as the JAX package does.
"""

import dataclasses
import json
import pathlib
import types

import jax
import numpy as np
import PIL.Image
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import frodo_slam_tpu.data as jdata_pkg  # noqa: E402
from frodo_slam_tpu import loader as jloader  # noqa: E402
from frodo_slam_tpu import main as jmain  # noqa: E402
from frodo_slam_tpu.config import make_config as j_make_config  # noqa: E402
from frodo_slam_tpu.models import convert as jconvert  # noqa: E402
from frodo_slam_tpu.models import mast3r as jmast3r  # noqa: E402
from frodo_slam_tpu.slam import system as jsystem  # noqa: E402
from frodo_slam_tpu_torch import loader as tloader  # noqa: E402
from frodo_slam_tpu_torch import main as tmain  # noqa: E402
from frodo_slam_tpu_torch.config import make_config as t_make_config  # noqa: E402
from frodo_slam_tpu_torch.data import datasets as tds  # noqa: E402
from frodo_slam_tpu_torch.data.prefetch import PrefetchLoader  # noqa: E402
from frodo_slam_tpu_torch.models import convert as tconvert  # noqa: E402
from frodo_slam_tpu_torch.models import mast3r as tmast3r  # noqa: E402
from frodo_slam_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from frodo_slam_tpu_torch.slam import system as tsystem  # noqa: E402
from test_torch_viz import check_served_and_stopped, spy_viewers  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every tracked frame becomes a keyframe and a backend task (random weights
# give low confidences: Q_conf 0)
OVERRIDES = """
matching: {refine_impl: gather}
tracking: {match_frac_thresh: 1.1, min_match_frac: 0.0, Q_conf: 0.0, max_iters: 10}
local_opt: {Q_conf: 0.0, min_match_frac: 0.0, max_iters: 5}
tpu: {max_keyframes: 8, max_edges: 8, max_odom_edges: 8}
"""


@pytest.fixture(scope="module")
def weights():
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]
    params["dec_blocks2"] = params["dec_blocks"]
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    return params, jcfg, model, tcfg


def _frame():
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (48, 64, 3), np.uint8)


def _folder(tmp_path, n=4):
    d = tmp_path / "data" / "seq01"
    d.mkdir(parents=True)
    for i in range(n):
        PIL.Image.fromarray(_frame()[:32]).save(d / f"{i:04d}.png")
    return d


def _folder8(tmp_path):
    return _folder(tmp_path, 8)


def _tum(tmp_path):
    """An fr1 sequence of 8 identical 640x480 frames (fr1's distortion is
    undistorted on both sides under use_calib)."""
    d = tmp_path / "data" / "tum" / "rgbd_dataset_freiburg1_xyz"
    (d / "rgb").mkdir(parents=True)
    img = np.asarray(PIL.Image.fromarray(_frame()).resize((640, 480), PIL.Image.BILINEAR))
    lines = ["# timestamp filename"]
    for i in range(8):
        ts = f"{1305031102.175304 + i / 30:.6f}"
        PIL.Image.fromarray(img).save(d / "rgb" / f"{ts}.png")
        lines.append(f"{ts} rgb/{ts}.png")
    (d / "rgb.txt").write_text("\n".join(lines) + "\n")
    return d


# (sequence, parent config, a --calib yaml, extra yaml lines)
CASES = {
    "folder": (_folder, "configs/base.yaml", False, ""),
    "folder_calib_yaml": (_folder, "configs/base.yaml", True, ""),
    "folder_pipelined": (_folder, "configs/base.yaml", False,
                         "tpu: {max_keyframes: 8, max_edges: 8, max_odom_edges: 8, pipelined_frontend: true}\n"),
    "tum_eval_calib": (_tum, "configs/eval_calib.yaml", False, ""),
    "folder_placement_shared": (_folder, "configs/base.yaml", False,
                                "tpu: {max_keyframes: 8, max_edges: 8, max_odom_edges: 8, placement: shared}\n"),
    # the real-time configurations: tpu.x64_eval false (the f32 window solve
    # with one refinement step on both sides), the pipelined frontend, the
    # config's compute types (REALTIME); bench_cli.yaml adds the threaded
    # backend and its gate overrides
    "folder_realtime": (_folder8, "configs/realtime.yaml", False, ""),
    "folder_bench_cli": (_folder8, "configs/bench_cli.yaml", False, ""),
}
# cases whose port run sees eight CPU aliases as its devices, as the JAX run
# sees the eight virtual devices of tests/conftest.py: tpu.placement shared
# gives both a (4, 2) backend grid
PLACED = {"folder_placement_shared"}
# cases whose loaders apply the config's head type to the tiny model, as the
# real loaders do (the transformer stays f32, as in the other cases), and
# record the type each head's DPT computed in. realtime.yaml's bf16 heads
# round differently in the two packages, so that case holds the keyframe
# pointmaps as below; its keyframes, their timestamps and the trajectories
# keep the other cases' bars
REALTIME = {"folder_realtime", "folder_bench_cli"}
# realtime.yaml's bars on the median relative difference of the stores'
# keyframe pointmaps and confidences. Readings (tiny width, 8 frames, CPU):
# port bf16 heads against JAX bf16 heads 0.01183 and 0.00412; the port's
# heads decoded in f32 against JAX bf16 heads 0.01468 and 0.00493. The bars
# lie between, so a port that ran its heads in f32 fails them.
REALTIME_BARS = {"X_canon": 0.0133, "C": 0.0045}


def _tiny_load(real):
    def load(path, **kw):
        ds = real(path, **kw)
        ds.img_size = 64  # 64-pixel long edge instead of 512
        return ds
    return load


def _run_both(tmp_path, monkeypatch, weights, case):
    params, jcfg, model, tcfg = weights
    make, parent, with_calib, extra = CASES[case]
    seq = make(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f'inherit: "{ROOT / parent}"\n{OVERRIDES}{extra}')
    calib = None
    if with_calib:
        calib = tmp_path / "calib.yaml"
        calib.write_text("width: 64\nheight: 32\ncalibration: [60.0, 60.0, 32.0, 16.0]\n")

    monkeypatch.setattr(tds, "load_dataset", _tiny_load(tds.load_dataset))
    monkeypatch.setattr(jdata_pkg, "load_dataset", _tiny_load(jdata_pkg.load_dataset))
    head_dtypes = set()  # what the port's heads computed in
    if case in REALTIME:
        def t_load(*a, cfg=None, device=None):
            c = dataclasses.replace(tcfg, head_dtype=cfg.head_dtype)
            m = tloader._from_state_dict(tconvert.state_dict_from_jax(params, c), c, torch.device("cpu"))
            for head in (m.downstream_head1, m.downstream_head2):
                head.dpt.register_forward_hook(lambda mod, args, out: head_dtypes.add(out.dtype))
            return m, c

        monkeypatch.setattr(tloader, "load_mast3r", t_load)
        monkeypatch.setattr(jloader, "load_mast3r", lambda *a, cfg=None: (
            params, dataclasses.replace(jcfg, head_dtype=cfg.head_dtype)))
    else:
        monkeypatch.setattr(tloader, "load_mast3r", lambda *a, **k: (model, tcfg))
        monkeypatch.setattr(jloader, "load_mast3r", lambda *a, **k: (params, jcfg))
    created = []

    class SpySLAM(tsystem.SLAM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)

    monkeypatch.setattr(tsystem, "SLAM", SpySLAM)
    j_created = []

    class JSpySLAM(jsystem.SLAM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            j_created.append(self)

    monkeypatch.setattr(jsystem, "SLAM", JSpySLAM)
    if case in PLACED:
        monkeypatch.setattr(tmesh, "visible_devices", lambda device=None: [torch.device("cpu")] * 8)
    outs = {}
    for name, mod, kw in (("jax", jmain, {}), ("port", tmain, {"device": "cpu"})):
        run_dir = tmp_path / name
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)  # logs/ lands here
        args = types.SimpleNamespace(
            dataset=str(seq), config=str(cfg), calib=str(calib) if calib else None,
            save_as="cli", no_viz=True, viz=False, weights=None, no_retrieval=True, max_frames=None)
        x64 = jax.config.jax_enable_x64
        try:  # the JAX runner sets x64 from tpu.x64_eval
            outs[name] = {k: (run_dir / v if k != "retrieval" else v) for k, v in mod.run(args, **kw).items()}
        finally:
            jax.config.update("jax_enable_x64", x64)
    return outs, created[0], seq, j_created[0], head_dtypes


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_runner_matches_jax_runner(tmp_path, monkeypatch, weights, case):
    outs, slam, seq, jslam, head_dtypes = _run_both(tmp_path, monkeypatch, weights, case)
    j, t = outs["jax"], outs["port"]
    assert t["retrieval"] == j["retrieval"] == "none"
    calibrated = "calib" in case
    assert slam.tcfg.use_calib == calibrated and (slam.K is not None) == calibrated
    placed = slam.placement
    assert (placed is None) == (case not in PLACED)
    if placed is not None:  # JAX default_mesh("shared") over 8 devices: (4, 2)
        assert (placed.dp, placed.tp, placed.backend_slots) == (4, 2, tuple(range(8))) and len(slam.backend.replicas) == 4

    realtime = case in REALTIME
    assert slam.ba_cfg.solve_f64 is not realtime and slam.backend.cfg.solve_f64 is not realtime
    assert (case == "folder_bench_cli") is not slam.single_thread

    rows_t, rows_j = np.loadtxt(t["traj"], dtype=str, ndmin=2), np.loadtxt(j["traj"], dtype=str, ndmin=2)
    # eval_calib subsamples by 2
    n_frames = 8 // 2 if case.startswith("tum") else 8 if realtime else 4
    assert rows_t.shape == rows_j.shape == (n_frames, 8)  # every frame a keyframe
    assert (rows_t[:, 0] == rows_j[:, 0]).all()
    bf16 = case == "folder_realtime"
    if realtime:
        assert head_dtypes == {torch.bfloat16 if bf16 else torch.float32}, head_dtypes
    np.testing.assert_allclose(rows_t[:, 1:].astype(float), rows_j[:, 1:].astype(float), atol=1e-4)
    assert np.isfinite(rows_t[:, 1:].astype(float)).all()

    pngs_t = sorted(pathlib.Path(t["keyframes"]).glob("*.png"))
    pngs_j = sorted(pathlib.Path(j["keyframes"]).glob("*.png"))
    assert [p.name for p in pngs_t] == [p.name for p in pngs_j] and len(pngs_t) == n_frames
    for a, b in zip(pngs_t, pngs_j):
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(a)), np.asarray(PIL.Image.open(b)))

    heads = [pathlib.Path(o["ply"]).read_bytes().split(b"end_header\n", 1) for o in (t, j)]
    pts = [np.frombuffer(b, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])["xyz"] for _, b in heads]
    if bf16:
        # bf16 heads: a point at the PLY's confidence gate may fall on either
        # side of it, so the counts agree within 2%, and the stores' keyframe
        # pointmaps and confidences within REALTIME_BARS
        assert abs(len(pts[0]) - len(pts[1])) <= 0.02 * len(pts[1])
        rows = [k % slam.store.capacity for k in range(slam.store.n_total)]
        for name in ("X_canon", "C"):
            got = getattr(slam.store, name)[rows].double().numpy()
            want = np.asarray(getattr(jslam.store, name), np.float64)[rows]
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
            assert np.median(rel) <= REALTIME_BARS[name], (name, np.median(rel))
    else:
        assert heads[0][0] == heads[1][0]
        np.testing.assert_allclose(pts[0], pts[1], rtol=1e-3, atol=1e-4)
    meta = pathlib.Path(t["traj"]).with_suffix(".meta.json")
    assert meta.exists() and meta.read_text() == pathlib.Path(j["traj"]).with_suffix(".meta.json").read_text()


def test_runner_refuses_what_later_slices_bring(tmp_path, monkeypatch, weights):
    """Retrieval is ported: without ``--no-retrieval`` the runner takes the
    random head + codebook fallback, relocalizes, and records it in the meta
    file. ``--viz`` is ported too: the live viewer serves during the run (it
    is fetched over HTTP at every frame gate) and is stopped after it."""
    _, _, model, tcfg = weights
    seq = _folder(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f'inherit: "{ROOT / "configs/base.yaml"}"\n{OVERRIDES}')
    monkeypatch.setattr(tloader, "load_mast3r", lambda *a, **k: (model, tcfg))
    monkeypatch.setattr(tds, "load_dataset", _tiny_load(tds.load_dataset))
    created = []

    class SpySLAM(tsystem.SLAM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)

    monkeypatch.setattr(tsystem, "SLAM", SpySLAM)
    monkeypatch.chdir(tmp_path)
    base = dict(dataset=str(seq), config=str(cfg), calib=None, weights=None, max_frames=None)
    with pytest.warns(UserWarning, match="random retrieval head"):
        out = tmain.run(types.SimpleNamespace(**base, save_as="ret", no_retrieval=False, viz=False),
                        device="cpu")
    assert out["retrieval"] == "random-fallback"
    meta = json.loads((tmp_path / "logs" / "ret" / f"{seq.name}.meta.json").read_text())
    assert meta["retrieval"] == "random-fallback" and meta["keyframes"] == 4
    slam, = created
    assert slam.retrieval is not None and slam.use_reloc and slam.retrieval.degraded
    assert slam.retrieval.kf_counter == 4  # every keyframe inserted
    viewers = spy_viewers(monkeypatch)
    tmain.run(types.SimpleNamespace(**base, save_as=None, no_retrieval=True, viz=True, viz_port=8090),
              device="cpu")
    check_served_and_stopped(viewers, n_gates=4)  # one gate a frame
    assert viewers[0].slam is created[-1] and viewers[0].slam.store.n_total == 4


def test_cli_parser_matches_jax():
    argv = ["--dataset", "d/tum/x", "--config", "c.yaml", "--calib", "k.yaml", "--save-as", "n",
            "--no-retrieval", "--max-frames", "7", "--weights", "w.pth"]
    assert vars(tmain.build_parser().parse_args(argv)) == vars(jmain.build_parser().parse_args(argv))


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

class _Frames:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"unreadable frame {i}")
        return float(i), np.full((4, 6, 3), i / 10, np.float32)


def test_prefetch_yields_every_frame_in_order():
    frames = PrefetchLoader(_Frames(7), lambda img: img[None] * 2 - 1, "cpu", depth=2, max_frames=5)
    got = list(frames)
    assert [ts for ts, _ in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    for i, (_, t) in enumerate(got):
        assert t.device.type == "cpu" and t.dtype == torch.float32 and tuple(t.shape) == (1, 4, 6, 3)
        torch.testing.assert_close(t, torch.full((1, 4, 6, 3), i / 5 - 1))


def test_prefetch_raises_at_the_failing_frame():
    seen = []
    with pytest.raises(OSError, match="frame 3"):
        for ts, _ in PrefetchLoader(_Frames(6, fail_at=3), lambda img: img[None], "cpu"):
            seen.append(ts)
    assert seen == [0.0, 1.0, 2.0]


def test_prefetch_stops_its_thread_when_the_consumer_stops():
    loader = PrefetchLoader(_Frames(50), lambda img: img[None], "cpu", depth=1)
    for ts, _ in loader:
        if ts == 2.0:
            break
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

def test_load_mast3r_from_npz(tmp_path, weights):
    params, _, model, tcfg = weights
    jconvert.save_npz(params, str(tmp_path / "ckpt.npz"))
    got, cfg = tloader.load_mast3r(str(tmp_path / "ckpt.pth"), cfg=tcfg, device="cpu")
    assert cfg == tcfg
    want = model.state_dict()
    sd = got.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0, msg=k)


def test_load_mast3r_random_tiny_shared(monkeypatch):
    monkeypatch.setenv("FRODO_ENTRY_TINY", "1")
    monkeypatch.setenv("FRODO_RANDOM_SHARE_DECODER", "1")
    with pytest.warns(UserWarning, match="RANDOM weights"):
        model, cfg = tloader.load_mast3r("missing.pth", cfg=tmast3r.MASt3RConfig(attention_impl="pallas"),
                                         device="cpu")
    jmodel_cfg = jmast3r.tiny_config()
    assert (cfg.enc_depth, cfg.enc_embed_dim, cfg.dec_embed_dim) == (
        jmodel_cfg.enc_depth, jmodel_cfg.enc_embed_dim, jmodel_cfg.dec_embed_dim)
    # the caller's explicit knob survives; tiny_config's f32 default too
    assert cfg.attention_impl == "pallas" and cfg.dtype == torch.float32
    for a, b in ((model.downstream_head1, model.downstream_head2), (model.dec_blocks, model.dec_blocks2)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("config", ["base.yaml", "realtime.yaml", "eval_calib.yaml", "bench_cli.yaml"])
def test_apply_model_knobs_matches_jax(config):
    path = str(ROOT / "configs" / config)
    got = tloader.apply_model_knobs(tmast3r.MASt3RConfig(), t_make_config(path))
    want = jloader.apply_tpu_model_knobs(jmast3r.MASt3RConfig(), j_make_config(path))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert str(got.head_dtype).split(".")[-1] == str(want.head_dtype)
    assert got.attention_impl == want.attention_impl
