"""PyTorch port vs JAX package: the VIO runner ``run_vio.run_dataset`` over
a recorded session (the pickle replay of ``OdometryData``), the fixture of
``tests/test_run_vio.py:19-32``: four identical BGR frames (64 px after the
runner's resize), an odometry pose per frame, ``--use_odometry`` (the VIO
mode), tiny weights converted from the JAX package's, serialized; once
more with ``--use_multiple_gpu`` (the port's devices eight CPU aliases).

Bars: keyframe count, backend pairs and odometry factors equal; keyframe
poses within 1e-4; the runner's CLI as JAX ``build_parser``."""

import pickle
import types

import jax
import numpy as np
import pytest
import torch

ROOT_CFG = "configs/base.yaml"


@pytest.fixture()
def session_pkl(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (40, 72, 3), np.uint8)
    frame = base[0:32, 0:64]
    items = [{"timestamp": float(i) / 10.0, "frame": frame,
              "pose": np.array([0.05 * i, 0, 0, 0, 0, 0, 1], np.float32)} for i in range(4)]
    p = tmp_path / "session_mini.pkl"
    with open(p, "wb") as f:
        pickle.dump(items, f)
    return p


def _cfg_yaml(tmp_path, tpu_extra=""):
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    p = tmp_path / "vio_test.yaml"
    p.write_text(
        f"inherit: {root / ROOT_CFG}\n"
        "single_thread: True\n"
        "matching:\n"
        "  refine_impl: gather\n"
        "tracking:\n"
        "  match_frac_thresh: 1.1\n"
        "  min_match_frac: 0.0\n"
        "  Q_conf: 0.0\n"
        "  max_iters: 10\n"
        "  use_fnn: False\n"
        "local_opt:\n"
        "  Q_conf: 0.0\n"
        "  min_match_frac: 0.0\n"
        "  max_iters: 2\n"
        "tpu:\n"
        "  max_keyframes: 8\n"
        "  max_edges: 8\n"
        "  max_odom_edges: 8\n" + tpu_extra)
    return p


def _run_both(session_pkl, tmp_path, monkeypatch, tpu_extra="", **extra):
    """JAX ``run_dataset`` and the port's (on the CPU) over the session with
    the same converted weights; ``tpu_extra`` yaml lines go into both
    configs' ``tpu:`` section, ``extra`` args to both runners. Returns (JAX
    SLAM, port SLAM, the devices the port's loader was asked for)."""
    from frodo_slam_tpu import loader as jloader
    from frodo_slam_tpu import run_vio as jrv
    from frodo_slam_tpu.data import image as jimage
    from frodo_slam_tpu.models import mast3r as jmast3r
    from frodo_slam_tpu.slam import system as jsystem
    from frodo_slam_tpu_torch import loader as tloader
    from frodo_slam_tpu_torch import run_vio as trv
    from frodo_slam_tpu_torch.data import image as timage
    from frodo_slam_tpu_torch.models import convert as tconvert
    from frodo_slam_tpu_torch.models import mast3r as tmast3r
    from frodo_slam_tpu_torch.slam import system as tsystem

    torch.set_num_threads(1)
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]
    params["dec_blocks2"] = params["dec_blocks"]
    monkeypatch.setattr(jloader, "load_mast3r", lambda *a, **k: (params, jcfg))
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    devices = []

    def t_load(path=None, cfg=None, device=None):
        devices.append(device)
        return model, tcfg

    monkeypatch.setattr(tloader, "load_mast3r", t_load)
    for mod, sysmod in ((jimage, jsystem), (timage, tsystem)):
        real = mod.resize_img

        def resize64(img, size=512, _real=real, **kw):
            return _real(img, 64, **kw)

        monkeypatch.setattr(mod, "resize_img", resize64)
        monkeypatch.setattr(sysmod, "resize_img", resize64)

    cfg = _cfg_yaml(tmp_path, tpu_extra)
    args = types.SimpleNamespace(dataset=str(session_pkl), config=str(cfg), weights=None, no_retrieval=True,
                                 use_odometry=True, wall_clock=False, every_n_frames=1, visualize=False,
                                 **extra)
    x64 = jax.config.jax_enable_x64
    try:  # the JAX runner sets x64 from tpu.x64_eval
        js = jrv.run_dataset(args)
    finally:
        jax.config.update("jax_enable_x64", x64)
    ts = trv.run_dataset(args, device="cpu")
    return js, ts, devices


def _assert_runs_agree(js, ts):
    assert ts.img_hw == js.img_hw == (32, 64)
    assert ts.store.n_total == int(js.store.n_total) >= 2
    assert ts.backend._pairs == js.backend._pairs
    assert ts.backend._odom_pairs == js.backend._odom_pairs and len(ts.backend._odom_pairs) >= 1
    assert ts.pgo.n_total == int(js.pgo.n_total) == ts.store.n_total - 1
    (st, pt), (sj, pj) = ts.keyframe_poses(), js.keyframe_poses()
    assert st == sj and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, atol=1e-4)


def test_run_dataset_matches_jax(session_pkl, tmp_path, monkeypatch):
    js, ts, devices = _run_both(session_pkl, tmp_path, monkeypatch)
    assert devices == ["cpu"] and ts.device.type == "cpu" and ts.local_opt_mode
    assert ts.placement is None  # device="cpu" is one device: no placement
    _assert_runs_agree(js, ts)


def test_run_dataset_use_multiple_gpu_matches_jax(session_pkl, tmp_path, monkeypatch):
    """``--use_multiple_gpu`` sets ``tpu.placement: overlap`` on both sides:
    JAX's backend mesh covers its virtual devices 1-7, the port's backend
    slots 1-7 of eight CPU aliases (the enumerator patched), the tracker
    slot 0."""
    from frodo_slam_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "visible_devices", lambda device=None: [torch.device("cpu")] * 8)
    js, ts, _ = _run_both(session_pkl, tmp_path, monkeypatch, use_multiple_gpu=True)
    pl = ts.placement
    assert (pl.dp, pl.tp, pl.backend_slots) == (7, 1, tuple(range(1, 8)))
    assert len(ts.backend.replicas) == 7
    _assert_runs_agree(js, ts)


def test_run_dataset_x64_off_matches_jax(session_pkl, tmp_path, monkeypatch):
    """``tpu.x64_eval: false`` in the replay's config: JAX runs its x64-off
    program, the port the f32 window solve with one refinement step and f32
    odometry rows; the same bars as the f64 replay."""
    js, ts, _ = _run_both(session_pkl, tmp_path, monkeypatch, tpu_extra="  x64_eval: false\n")
    assert ts.cfg["tpu"]["x64_eval"] is False
    assert not ts.ba_cfg.solve_f64 and not ts.backend.cfg.solve_f64
    _assert_runs_agree(js, ts)


class _RobotDone(Exception):
    pass


@pytest.mark.parametrize("x64_eval", [None, True])
def test_run_robot_resolves_real_time_numerics(tmp_path, monkeypatch, x64_eval):
    """The live robot mode defaults to the real-time numerics (JAX
    ``run_vio.py:123``: ``entry_default=False``), and an explicit
    ``tpu.x64_eval: true`` wins; the replay of the same config defaults to
    the f64 solve (``run_vio.py:54``). The robot is a fake that hands over
    three frames, then stops the loop."""
    from frodo_slam_tpu_torch import loader as tloader
    from frodo_slam_tpu_torch import run_vio as trv
    from frodo_slam_tpu_torch.data import image as timage
    from frodo_slam_tpu_torch.models import mast3r as tmast3r
    from frodo_slam_tpu_torch.slam import odometry as todom
    from frodo_slam_tpu_torch.slam import system as tsystem

    real = timage.resize_img
    for mod in (timage, tsystem):
        monkeypatch.setattr(mod, "resize_img", lambda img, size=512, **kw: real(img, 64, **kw))
    model = tmast3r.init_model(tmast3r.tiny_config(), seed=0, device="cpu")
    monkeypatch.setattr(tloader, "load_mast3r", lambda *a, **k: (model, model.cfg))
    frame = np.random.default_rng(0).integers(0, 255, (32, 64, 3), np.uint8)
    events = []

    class FakeRobot:
        def __init__(self, robot_type):
            self.n = 0

        def start(self):
            events.append("start")

        def stop(self):
            events.append("stop")

        def get_frame_and_pose(self):
            self.n += 1
            if self.n > 3:
                raise _RobotDone
            return 0.1 * self.n, frame, np.array([0.05 * self.n, 0, 0, 0, 0, 0, 1], np.float32)

    monkeypatch.setattr(todom, "StraightOrSpinOdometry", FakeRobot)
    created = []

    class SpySLAM(tsystem.SLAM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)

    monkeypatch.setattr(tsystem, "SLAM", SpySLAM)
    extra = "" if x64_eval is None else f"  x64_eval: {str(x64_eval).lower()}\n"
    args = types.SimpleNamespace(config=str(_cfg_yaml(tmp_path, extra)), weights=None, no_retrieval=True,
                                 robot_type="mini", use_odometry=True, visualize=False)
    with pytest.raises(_RobotDone):
        trv.run_robot(args, device="cpu")
    slam, = created
    assert events == ["start", "stop"] and slam.frame_count == 3 and slam.local_opt_mode
    assert slam.ba_cfg.solve_f64 is bool(x64_eval) and slam.cfg["tpu"]["x64_eval"] is bool(x64_eval)
    replay = trv._setup(types.SimpleNamespace(config=args.config, weights=None, no_retrieval=True),
                        "cpu", x64_default=True)[0]
    assert replay["tpu"]["x64_eval"] is (x64_eval is not False)


def test_run_dataset_every_n_and_empty(session_pkl, tmp_path, monkeypatch):
    """``every_n_frames`` keeps every n-th frame; an empty session gives
    None, as JAX's runner."""
    from frodo_slam_tpu_torch import loader as tloader
    from frodo_slam_tpu_torch import run_vio as trv
    from frodo_slam_tpu_torch.data import image as timage
    from frodo_slam_tpu_torch.models import mast3r as tmast3r
    from frodo_slam_tpu_torch.slam import system as tsystem

    real = timage.resize_img
    for mod in (timage, tsystem):
        monkeypatch.setattr(mod, "resize_img", lambda img, size=512, **kw: real(img, 64, **kw))

    model = tmast3r.init_model(tmast3r.tiny_config(), seed=0, device="cpu")
    monkeypatch.setattr(tloader, "load_mast3r", lambda *a, **k: (model, model.cfg))
    seen = []
    real_grab = trv._grab
    monkeypatch.setattr(trv, "_grab", lambda slam, cfg, img, ts, odom: seen.append((ts, odom)) or
                        real_grab(slam, cfg, img, ts, odom))
    args = types.SimpleNamespace(dataset=str(session_pkl), config=str(_cfg_yaml(tmp_path)), weights=None,
                                 no_retrieval=True, use_odometry=False, wall_clock=False, every_n_frames=2,
                                 visualize=False)
    slam = trv.run_dataset(args, device="cpu")
    assert [t for t, _ in seen] == [0.1, 0.3] and all(o is None for _, o in seen)
    assert not slam.local_opt_mode
    empty = tmp_path / "empty_mini.pkl"
    with open(empty, "wb") as f:
        pickle.dump([], f)
    args.dataset = str(empty)
    assert trv.run_dataset(args, device="cpu") is None


def test_build_parser_matches_jax():
    from frodo_slam_tpu import run_vio as jrv
    from frodo_slam_tpu_torch import run_vio as trv

    def options(p):
        return {a.dest: (tuple(a.option_strings), a.default) for a in p._actions if a.dest != "help"}

    assert options(trv.build_parser()) == options(jrv.build_parser())
    a = trv.build_parser().parse_args(["--dataset", "s.pkl", "--use_odometry", "--every_n_frames", "2"])
    assert a.use_odometry and a.every_n_frames == 2 and a.config == "configs/base_no_fnn.yaml"
